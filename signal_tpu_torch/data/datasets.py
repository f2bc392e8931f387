"""Dataset scanners for RGBNT201 / RGBNT100 / MSVR310 (+ synthetic) (the
port's own copy of `signal_tpu/data/datasets.py`).

Filename→(pid, camid, [sceneid]) parsing mirrors the reference scanners:

* RGBNT201 (`data/datasets/RGBNT201.py:61-87` in maxingan2412/Signal):
  `train_171|test/{RGB,NI,TI}/*.jpg`; pid = int(name.split('_')[0][:6]),
  camid = int(name.split('_')[1][3]) − 1; three files per sample.
* RGBNT100 (`data/datasets/RGBNT100.py:63-85`): market-style
  `bounding_box_train|query|bounding_box_test/*.jpg` with `(pid)_c(cam)`
  regex; ONE 768×256 jpg holds RGB|NI|TI side by side (crop at read,
  `bases.py:18-22`).
* MSVR310 (`data/datasets/msvr310.py:67-88`): per-id dirs with
  `vis/ni/th` subdirs; pid = name[0:4], sceneid = name[6:9],
  camid = name[11].
* MSVWild863 (`data/datasets/MSVWild863.py:62-86`): flat `vis/ni/th`
  subdirs under train|query|test; RGBNT201-style filename parse.

Each record: (paths, pid, camid, trackid_or_sceneid). ``paths`` is a
3-tuple of per-modality files, or a single path for RGBNT100's packed jpg.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import re
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

Record = Tuple[object, int, int, int]  # (paths, pid, camid, track/scene id)


@dataclass
class ReIDDataset:
    name: str
    train: List[Record] = field(default_factory=list)
    query: List[Record] = field(default_factory=list)
    gallery: List[Record] = field(default_factory=list)
    packed_modalities: bool = False  # RGBNT100: one jpg → 3 crops

    def _info(self, data: Sequence[Record]):
        pids = {r[1] for r in data}
        cams = {r[2] for r in data}
        tracks = {r[3] for r in data}
        return len(pids), len(data), len(cams), len(tracks)

    @property
    def num_train_pids(self):
        return self._info(self.train)[0]

    @property
    def num_train_cams(self):
        return self._info(self.train)[2]

    @property
    def num_train_vids(self):
        return self._info(self.train)[3]

    def summary(self) -> str:
        rows = ["  subset   | # ids | # images | # cameras",
                "  ----------------------------------------"]
        for label, data in (("train", self.train), ("query", self.query),
                            ("gallery", self.gallery)):
            p, n, c, _ = self._info(data)
            rows.append(f"  {label:<8} | {p:5d} | {n:8d} | {c:9d}")
        return "\n".join(rows)


def _scan_rgbnt201(dir_path: str, relabel: bool,
                   mods: Tuple[str, str, str] = ("RGB", "NI", "TI"),
                   ) -> List[Record]:
    """RGBNT201-style scan: shared filenames across three modality
    subdirs (``mods``), pid = name[:6], camid = name.split('_')[1][3]−1.
    MSVWild863 reuses this with mods=('vis','ni','th')."""
    rgb_paths = sorted(glob.glob(osp.join(dir_path, mods[0], "*.jpg")))
    pids = sorted({int(osp.basename(p).split("_")[0][:6]) for p in rgb_paths})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    data = []
    for rgb in rgb_paths:
        name = osp.basename(rgb)
        pid = int(name.split("_")[0][:6])
        camid = int(name.split("_")[1][3]) - 1
        if relabel:
            pid = pid2label[pid]
        paths = (rgb, osp.join(dir_path, mods[1], name),
                 osp.join(dir_path, mods[2], name))
        data.append((paths, pid, camid, -1))
    return data


def _scan_rgbnt100(dir_path: str, relabel: bool) -> List[Record]:
    paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pattern = re.compile(r"([-\d]+)_c([-\d]+)")
    pids = sorted({int(pattern.search(p).group(1)) for p in paths
                   if int(pattern.search(p).group(1)) != -1})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    data = []
    for p in paths:
        pid, camid = map(int, pattern.search(p).groups())
        if relabel:
            pid = pid2label[pid]
        data.append((p, pid, camid - 1, -1))
    return data


def _scan_msvr310(dir_path: str, relabel: bool) -> List[Record]:
    vids = sorted(os.listdir(dir_path), key=lambda v: int(v))
    vid2label = {int(v): i for i, v in enumerate(vids)}
    data = []
    for vid in vids:
        vis_dir = osp.join(dir_path, vid, "vis")
        for img in sorted(os.listdir(vis_dir)):
            paths = (osp.join(dir_path, vid, "vis", img),
                     osp.join(dir_path, vid, "ni", img),
                     osp.join(dir_path, vid, "th", img))
            pid = int(img[0:4])
            sceneid = int(img[6:9])
            camid = int(img[11])
            if relabel:
                pid = vid2label[pid]
            data.append((paths, pid, camid, sceneid))
    return data


def _scan_msvwild863(dir_path: str, relabel: bool) -> List[Record]:
    """MSVWild863 (`data/datasets/MSVWild863.py:62-86` in
    maxingan2412/Signal): the RGBNT201 scan over `{vis,ni,th}` subdirs.
    Relabel here is sorted (deterministic) where the reference
    enumerates a set."""
    return _scan_rgbnt201(dir_path, relabel, mods=("vis", "ni", "th"))


def build_dataset(name: str, root: str) -> ReIDDataset:
    root = osp.abspath(osp.expanduser(root))
    if name == "RGBNT201":
        base = osp.join(root, "RGBNT201")
        return ReIDDataset(
            name,
            train=_scan_rgbnt201(osp.join(base, "train_171"), relabel=True),
            query=_scan_rgbnt201(osp.join(base, "test"), relabel=False),
            gallery=_scan_rgbnt201(osp.join(base, "test"), relabel=False),
        )
    if name == "RGBNT100":
        base = osp.join(root, "RGBNT100", "rgbir")
        return ReIDDataset(
            name,
            train=_scan_rgbnt100(osp.join(base, "bounding_box_train"), relabel=True),
            query=_scan_rgbnt100(osp.join(base, "query"), relabel=False),
            gallery=_scan_rgbnt100(osp.join(base, "bounding_box_test"), relabel=False),
            packed_modalities=True,
        )
    if name == "MSVR310":
        base = osp.join(root, "MSVR310")
        return ReIDDataset(
            name,
            train=_scan_msvr310(osp.join(base, "bounding_box_train"), relabel=True),
            query=_scan_msvr310(osp.join(base, "query3"), relabel=False),
            gallery=_scan_msvr310(osp.join(base, "bounding_box_test"), relabel=False),
        )
    if name == "MSVWild863":
        base = osp.join(root, "MSVWild863")
        return ReIDDataset(
            name,
            train=_scan_msvwild863(osp.join(base, "train"), relabel=True),
            query=_scan_msvwild863(osp.join(base, "query"), relabel=False),
            gallery=_scan_msvwild863(osp.join(base, "test"), relabel=False),
        )
    if name in ("market1501", "dukemtmc", "msmt17"):
        return _legacy_single_modality(name, root)
    if name == "synthetic":
        return synthetic_dataset()
    raise KeyError(f"Unknown dataset {name!r}")


def _scan_market_style(dir_path: str, relabel: bool) -> List[Record]:
    """Market-1501-style `(pid)_c(cam)` jpgs; single modality replicated to
    the 3-stream pipeline (legacy datasets are registered-but-unused in the
    reference Signal configs, `data/datasets/make_dataloader.py:15-22`)."""
    paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pattern = re.compile(r"([-\d]+)_c(\d+)")
    pids = sorted({int(pattern.search(p).group(1)) for p in paths
                   if int(pattern.search(p).group(1)) != -1})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    data = []
    for p in paths:
        pid, camid = map(int, pattern.search(p).groups())
        if pid == -1:
            continue  # junk images
        if relabel:
            pid = pid2label[pid]
        data.append(((p, p, p), pid, camid - 1, -1))
    return data


_LEGACY_DIRS = {
    "market1501": ("Market-1501-v15.09.15",
                   "bounding_box_train", "query", "bounding_box_test"),
    "dukemtmc": ("DukeMTMC-reID",
                 "bounding_box_train", "query", "bounding_box_test"),
    "msmt17": ("MSMT17", "train", "query", "test"),
}


def _legacy_single_modality(name: str, root: str) -> ReIDDataset:
    sub, train_d, query_d, gallery_d = _LEGACY_DIRS[name]
    base = osp.join(root, sub)
    return ReIDDataset(
        name,
        train=_scan_market_style(osp.join(base, train_d), relabel=True),
        query=_scan_market_style(osp.join(base, query_d), relabel=False),
        gallery=_scan_market_style(osp.join(base, gallery_d), relabel=False),
    )


def synthetic_dataset(num_pids: int = 8, per_pid: int = 10, num_cams: int = 4,
                      seed: int = 0) -> ReIDDataset:
    """In-memory dataset for tests/benchmarks; 'paths' are RNG seeds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mk = lambda pid, i, cam: ((f"synth:{pid}:{i}:0", f"synth:{pid}:{i}:1",  # noqa: E731
                               f"synth:{pid}:{i}:2"), pid, cam, -1)
    train, query, gallery = [], [], []
    for pid in range(num_pids):
        cams = rng.integers(0, num_cams, per_pid)
        for i in range(per_pid):
            train.append(mk(pid, i, int(cams[i])))
        query.append(mk(pid, per_pid, 0))
        gallery.append(mk(pid, per_pid + 1, 1))
    return ReIDDataset("synthetic", train=train, query=query, gallery=gallery)
