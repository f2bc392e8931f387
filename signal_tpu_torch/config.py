"""Config system: dataclass tree mirroring the reference's YACS knobs.

The PyTorch port's own copy of `signal_tpu/config.py`: the same knob
names (`config/defaults.py:1-181` in maxingan2412/Signal), so the YAML
configs under `configs/` load unmodified into both packages, and CLI
`KEY VALUE` override lists behave like `cfg.merge_from_list`. The one
default that differs is ``MODEL.DEVICE``: the port runs on ``"cuda"``
unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Tuple


@dataclass
class ModelConfig:
    DEVICE: str = "cuda"              # 'cuda' | 'cpu' (never a silent fallback)
    DEVICE_ID: str = "0"
    NAME: str = "Signal"
    PRETRAIN_PATH_T: str = ""
    # checkpoint for the CLIP tower (torch .pt state_dict or orbax dir).
    PRETRAIN_PATH_CLIP: str = ""
    NECK: str = "bnneck"
    IF_WITH_CENTER: str = "no"
    ID_LOSS_TYPE: str = "softmax"
    ID_LOSS_WEIGHT: float = 1.0
    TRIPLET_LOSS_WEIGHT: float = 1.0
    Gram_Loss_weight: float = 0.15
    PAT_Loss_weight: float = 0.1
    MoE_Loss_weight: float = 0.1
    METRIC_LOSS_TYPE: str = "triplet"
    DIST_TRAIN: bool = False
    PROMPT: bool = False
    ADAPTER: bool = False
    FROZEN: bool = False
    IF_LABELSMOOTH: str = "on"
    DIRECT: int = 1
    DROP_PATH: float = 0.1
    DROP_OUT: float = 0.0
    ATT_DROP_RATE: float = 0.0
    TRANSFORMER_TYPE: str = "ViT-B-16"
    STRIDE_SIZE: Tuple[int, int] = (16, 16)
    USE_A: bool = False
    USE_B: bool = False
    TOPK: int = 64
    FIXED_KEEP_RATIO: bool = False
    KEEP_RATIO: float = 0.75
    stageName: str = "CLS"
    SIE_COE: float = 3.0
    SIE_CAMERA: bool = True
    SIE_VIEW: bool = False
    NO_MARGIN: bool = True
    # --- knobs of the JAX package (no reference equivalent) ---
    COMPUTE_DTYPE: str = "bfloat16"   # matmul dtype; LN/softmax stay fp32
    # the name is kept so the shared YAMLs load; in the port it routes the
    # ViT blocks' attention through the CUDA kernel
    # (signal_tpu_torch/csrc/attention_fwd.cu) instead of the eager core
    USE_PALLAS_ATTENTION: bool = True
    REMAT: bool = True                 # per-block rematerialization in backward
    REMAT_POLICY: str = "full"         # 'full' (save nothing) | 'dots' (save matmul outs)
                                       # | 'attn' (save attention outs) | 'attn_mlp'
                                       # (save attention+MLP outs) | 'half' (remat only
                                       # the first 6 blocks); see models/vit.py
    MOE_EXPERTS: int = 0               # >1: CLIP blocks' MLP becomes a routed MoE
                                       # (ops/moe.py); gives the reference's dormant
                                       # MoE_Loss_weight knob its consumer (the Switch
                                       # load-balance aux loss). Experts shard over the
                                       # mesh 'model' axis (expert parallelism).
    MOE_TOPK: int = 1                  # experts per token (1 = Switch, 2 = GShard-ish)
    MOE_CAPACITY: float = 1.25         # per-group capacity factor (C = cf·k·L/E);
                                       # over-capacity tokens ride the residual
    SCAN_UNROLL: int = 1               # lax.scan unroll over the CLIP tower's ViT blocks
                                       # (Signal path only — the imagenet tower is a
                                       # Python loop, i.e. always fully unrolled; t2t and
                                       # clipreid stay rolled): 1 = rolled while-loop
                                       # (compact HLO), N = unroll N blocks per iteration
                                       # (trades compile time for removing the scan's
                                       # dynamic-slice/DUS + layout copies)


@dataclass
class InputConfig:
    SIZE_TRAIN: Tuple[int, int] = (256, 128)
    SIZE_TEST: Tuple[int, int] = (256, 128)
    PROB: float = 0.5
    RE_PROB: float = 0.5
    PIXEL_MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    PIXEL_STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    PADDING: int = 10


@dataclass
class DatasetsConfig:
    NAMES: str = "RGBNT201"
    ROOT_DIR: str = "./data"


@dataclass
class DataloaderConfig:
    NUM_WORKERS: int = 6
    SAMPLER: str = "softmax_triplet"
    NUM_INSTANCE: int = 8
    # run flip/pad+crop/erase on device inside the jitted train step
    # (host does decode+bicubic-resize+normalize only — native C++ on jpg
    # batches). Same augmentation distribution as the reference's
    # torchvision pipeline; set False for the host-side TrainTransform.
    DEVICE_AUGMENT: bool = True
    # ship uint8 pixels to the device and run torchvision-Normalize there
    # (fused into the patch conv; 4x less host->device transfer). The
    # uint8 rounding matches PIL's post-resample quantization bit-exactly.
    DEVICE_NORMALIZE: bool = True


@dataclass
class SolverConfig:
    OPTIMIZER_NAME: str = "SGD"
    MAX_EPOCHS: int = 120
    BASE_LR: float = 0.009
    LARGE_FC_LR: bool = False
    BIAS_LR_FACTOR: float = 2.0
    MOMENTUM: float = 0.9
    MARGIN: float = 0.3
    CLUSTER_MARGIN: float = 0.3
    CENTER_LR: float = 0.5
    CENTER_LOSS_WEIGHT: float = 0.0005
    RANGE_K: int = 2
    RANGE_MARGIN: float = 0.3
    RANGE_ALPHA: int = 0
    RANGE_BETA: int = 1
    RANGE_LOSS_WEIGHT: int = 1
    WEIGHT_DECAY: float = 1e-4
    WEIGHT_DECAY_BIAS: float = 1e-4
    GAMMA: float = 0.1
    STEPS: Tuple[int, ...] = (40, 70)
    WARMUP_FACTOR: float = 0.01
    WARMUP_ITERS: int = 10
    WARMUP_METHOD: str = "linear"
    COSINE_MARGIN: float = 0.5
    COSINE_SCALE: int = 30
    SEED: int = 1234
    CHECKPOINT_PERIOD: int = 50
    LOG_PERIOD: int = 10
    EVAL_PERIOD: int = 5
    IMS_PER_BATCH: int = 128
    # --- TPU-native knob (no reference equivalent) ---
    # gradient accumulation: split the global batch into ACCUM_ITER
    # contiguous microbatches run sequentially (lax.scan) with ONE
    # optimizer update on the averaged grads — large effective batches
    # beyond HBM. Batch-level losses (triplet mining, GAM) operate
    # within each microbatch; keep IMS_PER_BATCH/ACCUM_ITER a multiple
    # of DATALOADER.NUM_INSTANCE so P×K identity groups stay intact.
    ACCUM_ITER: int = 1


@dataclass
class TestConfig:
    EVAL: bool = False
    IMS_PER_BATCH: int = 256
    RE_RANKING: str = "no"
    WEIGHT: str = ""
    NECK_FEAT: str = "before"
    FEAT_NORM: str = "yes"
    MISS: str = "None"
    FEAT: int = 0
    # MSVR310 rank-list dump destination (the reference always writes
    # `re.txt` to the cwd, `utils/metrics.py:38,71-78`; here it is opt-in)
    RANK_DUMP: str = ""


@dataclass
class ParallelConfig:
    """TPU mesh layout (no reference equivalent; replaces NCCL DDP)."""
    DATA_AXIS: int = -1   # -1: remaining devices on the data axis
    MODEL_AXIS: int = 1   # tensor-parallel degree over attention heads/MLP
    # GPipe pipeline over the CLIP ViT blocks (parallel/pipeline.py);
    # mutually exclusive with MODEL_AXIS > 1
    PIPE_AXIS: int = 1        # pipeline stages (must divide MODEL layers)
    PIPE_MICROBATCH: int = 0  # microbatches per step (0 → = PIPE_AXIS)
    # Megatron-style sequence parallelism (requires MODEL_AXIS > 1):
    # the ViT residual stream between blocks shards its TOKEN dim over
    # 'model', so LN/residual/MLP-elementwise memory drops tp× and the
    # attention out-proj all-reduce becomes reduce-scatter + all-gather
    # (parallel/mesh.py::sequence_constrain). No-op without a TP mesh.
    SEQUENCE: bool = False
    # ZeRO-1: shard optimizer moments over 'data'
    # (parallel/mesh.py::zero1_shardings) — params stay replicated
    SHARD_OPT_STATE: bool = False


@dataclass
class Config:
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    INPUT: InputConfig = field(default_factory=InputConfig)
    DATASETS: DatasetsConfig = field(default_factory=DatasetsConfig)
    DATALOADER: DataloaderConfig = field(default_factory=DataloaderConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)
    OUTPUT_DIR: str = "./test"
    ckpt_save_path: str = "baseline"
    ckpt_test_path: str = "test_RNT"

    # ------------------------------------------------------------------
    def clone(self) -> "Config":
        return copy.deepcopy(self)

    def merge_from_file(self, path: str) -> "Config":
        import yaml  # PyYAML ships with the baked-in deps

        with open(path) as f:
            tree = yaml.safe_load(f)
        _merge_tree(self, tree or {})
        return self

    def merge_from_list(self, opts: List[str]) -> "Config":
        """Reference-style ['MODEL.USE_A', 'True', ...] override list."""
        assert len(opts) % 2 == 0, f"override list must be key/value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node: Any = self
            *parents, leaf = key.split(".")
            for p in parents:
                node = getattr(node, p)
            old = getattr(node, leaf)
            setattr(node, leaf, _coerce(value, old))
        return self

    def dump(self) -> str:
        return _dump(self, 0)


def _coerce(value: Any, old: Any) -> Any:
    if isinstance(value, str):
        try:
            ev = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            ev = value
        if isinstance(old, str):
            # "('RGBNT201')"-style strings appear in the reference YAMLs;
            # unwrap only if the literal is itself a string (never turn a
            # str knob into a number/bool)
            value = ev if isinstance(ev, str) else value
        else:
            value = ev
    if isinstance(old, str) and isinstance(value, bool):
        # unquoted YAML yes/on parses as bool — the yes/no & on/off knobs
        # (FEAT_NORM, RE_RANKING, IF_LABELSMOOTH) compare against strings,
        # so a silent bool would permanently disable them
        raise ValueError(
            f"got YAML bool {value!r} for a string knob (quote it: "
            f"'yes'/'no'/'on'/'off')")
    if isinstance(old, tuple):
        if not isinstance(value, (list, tuple)):
            raise ValueError(
                f"expected a list for this knob, got {value!r} "
                f"(e.g. [16, 16], not a bare scalar)")
        return tuple(value)
    if isinstance(old, bool) and isinstance(value, str):
        return value.lower() in ("true", "1", "yes", "on")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    return value


def _merge_tree(node: Any, tree: dict) -> None:
    for key, value in tree.items():
        if not hasattr(node, key):
            raise KeyError(f"Unknown config key: {key}")
        old = getattr(node, key)
        if dataclasses.is_dataclass(old) and isinstance(value, dict):
            _merge_tree(old, value)
        else:
            # YAML strings like "('RGBNT201')" appear in the reference YAMLs
            setattr(node, key, _coerce(value, old))


def _dump(node: Any, indent: int) -> str:
    lines = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if dataclasses.is_dataclass(v):
            lines.append(" " * indent + f.name + ":")
            lines.append(_dump(v, indent + 2))
        else:
            lines.append(" " * indent + f"{f.name}: {v!r}")
    return "\n".join(lines)


def default_config() -> Config:
    return Config()


def load_config(yaml_path: str | None = None, opts: List[str] | None = None) -> Config:
    cfg = Config()
    if yaml_path:
        cfg.merge_from_file(yaml_path)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
