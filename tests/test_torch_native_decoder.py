"""Port parity: the native JPEG decoder (``signal_tpu_torch/data/
native_decoder.py``, built from ``native/decoder.cpp`` into
``build/native/``) against ``signal_tpu/data/native_decoder.py`` built from
the same source, against PIL, and through the port's val loader. Skips
where the decoder cannot be built (no ``g++`` or no libjpeg)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from signal_tpu.data import native_decoder as jnd
from signal_tpu_torch.config import load_config
from signal_tpu_torch.data import make_dataloader
from signal_tpu_torch.data import native_decoder as tnd

MODS = ("RGB", "NI", "TI")


@pytest.fixture(scope="module")
def decoders():
    if not tnd.available():
        pytest.skip(f"native decoder not buildable here: {tnd.unavailable_reason()}")
    if not jnd.available():
        pytest.skip("the JAX package's native decoder is not built (make -C native)")
    return tnd, jnd


def _jpegs(root, n, hw, seed, name="{i}.jpg"):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(root, name.format(i=i))
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(p, quality=95)
        paths.append(p)
    return paths


@pytest.mark.parametrize("layout", ["files", "packed"])
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_outputs_equal_the_jax_decoder_bit_for_bit(tmp_path, decoders, layout, filt):
    """One C++ source, one set of flags: the uint8 and float outputs are
    the JAX package's, bit for bit (upscaled 128×64 files, or 768-wide
    packed RGB|NI|TI panes resampled to 256×128)."""
    t, j = decoders
    if layout == "files":
        paths = _jpegs(str(tmp_path), 4, (128, 64), 0)
        u8_t = t.decode_batch_u8(paths, 256, 128, 2, filter=filt)
        u8_j = j.decode_batch_u8(paths, 256, 128, 2, filter=filt)
        f_t = t.decode_batch(paths, 256, 128, (0.5, 0.4, 0.3), (0.2, 0.3, 0.4), 2, filter=filt)
        f_j = j.decode_batch(paths, 256, 128, (0.5, 0.4, 0.3), (0.2, 0.3, 0.4), 2, filter=filt)
        shape = (4, 3, 256, 128)
    else:
        paths = _jpegs(str(tmp_path), 3, (200, 600), 1)
        u8_t = t.decode_batch_packed_u8(paths, 256, 128, 2, filter=filt)
        u8_j = j.decode_batch_packed_u8(paths, 256, 128, 2, filter=filt)
        f_t = t.decode_batch_packed(paths, 256, 128, (0.5,) * 3, (0.5,) * 3, 2, filter=filt)
        f_j = j.decode_batch_packed(paths, 256, 128, (0.5,) * 3, (0.5,) * 3, 2, filter=filt)
        shape = (3, 3, 3, 256, 128)
    assert isinstance(u8_t, torch.Tensor) and u8_t.dtype == torch.uint8
    assert tuple(u8_t.shape) == shape and f_t.dtype == torch.float32
    assert np.array_equal(u8_t.numpy(), u8_j)
    assert np.array_equal(f_t.numpy(), f_j)


@pytest.mark.parametrize("case,filt,pil", [("small", "bilinear", Image.BILINEAR),
                                            ("small", "bicubic", Image.BICUBIC),
                                            ("exact", "bilinear", Image.BILINEAR)])
def test_u8_within_one_lsb_of_pil(tmp_path, decoders, case, filt, pil):
    """``tests/test_data.py``'s cases and tolerance for the JAX decoder (a
    128×64 upscale and a 256×128 identity, from its seed): PIL resamples
    in int16 fixed point, the decoder in float, so at most 1 LSB apart on
    < 2 % of pixels. (On other noise images the bicubic upscale can reach
    2 LSB, in both packages: their outputs are the same bits.)"""
    t, _ = decoders
    rng = np.random.default_rng(1)
    imgs = {"small": rng.integers(0, 255, (128, 64, 3), dtype=np.uint8),
            "exact": rng.integers(0, 255, (256, 128, 3), dtype=np.uint8)}
    p = str(tmp_path / f"{case}.jpg")
    Image.fromarray(imgs[case]).save(p, quality=95)
    got = t.decode_batch_u8([p], 256, 128, 1, filter=filt).numpy()[0]
    ref = np.asarray(Image.open(p).convert("RGB").resize((128, 256), pil)).transpose(2, 0, 1)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def test_decode_failure_raises(tmp_path, decoders):
    t, _ = decoders
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(IOError, match="failed to decode"):
        t.decode_batch_u8([str(bad)], 256, 128)


def _rgbnt201(root, n_ids=3, per_id=2, seed=4):
    """RGBNT201 layout, random 128×64 triplets:
    ``RGBNT201/{train_171,test}/{RGB,NI,TI}/<pid6>_cam<c>_<i>.jpg``."""
    rng = np.random.default_rng(seed)
    for split in ("train_171", "test"):
        for pid in range(1, n_ids + 1):
            for i in range(per_id):
                name = f"{pid:06d}_cam{1 + i % 4}_{i:02d}.jpg"
                for m in MODS:
                    d = os.path.join(root, "RGBNT201", split, m)
                    os.makedirs(d, exist_ok=True)
                    Image.fromarray(rng.integers(0, 256, (128, 64, 3), dtype=np.uint8)).save(
                        os.path.join(d, name), quality=95)
    return root


def _cfg(root, *opts):
    return load_config(None, ["DATASETS.NAMES", "RGBNT201", "DATASETS.ROOT_DIR", root,
                              "INPUT.SIZE_TEST", "[64, 32]", "INPUT.SIZE_TRAIN", "[64, 32]",
                              "TEST.IMS_PER_BATCH", "4", "SOLVER.IMS_PER_BATCH", "4",
                              "DATALOADER.NUM_INSTANCE", "2", "DATALOADER.NUM_WORKERS", "2",
                              "MODEL.DEVICE", "cpu", *opts])


@pytest.mark.parametrize("emit_u8", [True, False])
def test_val_loader_takes_the_native_path(tmp_path, decoders, monkeypatch, emit_u8):
    """Query and gallery (6 + 6 triplets of 3-file jpgs) go through the
    decoder a whole batch at a time
    (``loader.decoder == 'native'``); the PIL path's batch (the decoder
    made unavailable) agrees to the tolerance above (uint8), or within
    that LSB after Normalize (float: the decoder keeps the resampled
    value, PIL rounds it to uint8 first, as ``tests/test_data.py`` says)."""
    root = _rgbnt201(str(tmp_path))
    opts = [] if emit_u8 else ["DATALOADER.DEVICE_NORMALIZE", "False"]
    val = make_dataloader(_cfg(root, *opts))[2]
    native = list(val)
    assert val.decoder == "native"
    assert sum(b["valid"] for b in native) == 12 and native[0]["packed"].shape == (4, 3, 3, 64, 32)
    assert native[0]["packed"].dtype == (np.uint8 if emit_u8 else np.float32)
    monkeypatch.setattr(tnd, "available", lambda: False)
    pil = list(val)
    assert val.decoder == "pil"
    for a, b in zip(native, pil):
        assert a["names"] == b["names"] and np.array_equal(a["pids"], b["pids"])
        diff = np.abs(a["packed"].astype(np.float64) - b["packed"].astype(np.float64))
        if emit_u8:
            assert diff.max() <= 1 and (diff > 0).mean() < 0.02
        else:
            assert diff.max() <= (1.0 / 255.0) / 0.5 + 1e-5


def test_train_loader_decodes_packed_jpgs_bicubic(tmp_path, decoders):
    """Packed 768-wide jpgs (the RGBNT100 layout) through the device-
    augment train transform: whole batches on the decoder with its bicubic
    filter, equal to the JAX decoder's."""
    from signal_tpu_torch.data.loader import _BatchLoader
    from signal_tpu_torch.data.transforms import RawTrainDecode

    paths = _jpegs(str(tmp_path), 4, (128, 768), 5, name="{i:04d}_c1s1_0001.jpg")
    records = [(p, i // 2, 0, -1) for i, p in enumerate(paths)]
    tf = RawTrainDecode((64, 32), (0.5,) * 3, (0.5,) * 3)
    loader = _BatchLoader(records, tf, 4, lambda: [0, 1, 2, 3], drop_last=True, seed=0,
                          num_threads=2, emit_u8=True)
    (batch,) = list(loader)
    assert loader.decoder == "native" and batch["packed"].shape == (4, 3, 3, 64, 32)
    want = jnd.decode_batch_packed_u8(paths, 64, 32, 2, filter="bicubic")
    assert np.array_equal(batch["packed"], want)


def test_library_name_follows_the_host_cpu(monkeypatch):
    """The build uses ``-march=native``: a library built for another CPU
    (a ``build/native/`` carried between hosts) gets another name, so it
    is rebuilt rather than loaded. Needs no compiler."""
    first = tnd.library_path()
    assert tnd.library_path() == first and first.parent == tnd.BUILD_DIR
    monkeypatch.setattr(tnd, "_host_cpu", lambda: b"model name : another cpu")
    assert tnd.library_path() != first
