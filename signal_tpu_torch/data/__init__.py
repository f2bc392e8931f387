from signal_tpu_torch.data.datasets import build_dataset  # noqa: F401
from signal_tpu_torch.data.loader import make_dataloader  # noqa: F401
