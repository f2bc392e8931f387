"""A toy cell for the CPU tests: the rgbnt201 configuration file with a
two-layer tower 64 wide on 64×64 images (a 4×4 patch grid, the least
LAM's offsets take), SIM TOPK 3, batches of 8 (2 identities × 4), and a
pool of 4 batches. The port's plain PyTorch versions stand in for its
kernels on the CPU."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def toy_cell(kind: str, compute_dtype: str = "bfloat16"):
    from portbench import spec

    cfg = json.loads((ROOT / "portbench/configs/rgbnt201-signal.json").read_text())
    cfg["architecture"].update(width=64, layers=2, heads=4, feat_dim=32)
    cfg["published"]["INPUT"].update(SIZE_TRAIN=[64, 64], SIZE_TEST=[64, 64])
    cfg["published"]["MODEL"]["TOPK"] = 3
    cfg["published"]["SOLVER"]["IMS_PER_BATCH"] = 8
    cfg["published"]["DATALOADER"]["NUM_INSTANCE"] = 4
    cfg["published"]["TEST"]["IMS_PER_BATCH"] = 8
    cfg["assumed"].update(num_classes=8, camera_num=2)
    cfg["port"]["MODEL"].update(DEVICE="cpu", COMPUTE_DTYPE=compute_dtype)
    name = "train-pk" if kind == "train" else "gallery-stream"
    traffic = json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())
    traffic["pool_batches"] = 4
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return spec.Cell(name="toy", chips=1, config=cfg, traffic=traffic, per_layer=[],
                     end_to_end=bench["end_to_end"])


def toy_run(kind: str, compute_dtype: str = "bfloat16", seed: int = 2 ** 31 + 7):
    import torch

    from portbench import harness

    return harness.Run(cell=toy_cell(kind, compute_dtype), seed=seed, seconds=0.5, trace=False,
                       device=torch.device("cpu"), t_start=time.perf_counter())


@pytest.fixture
def cuda_card():
    """Skips the test where there is no CUDA card (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
