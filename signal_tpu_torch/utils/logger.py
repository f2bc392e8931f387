"""stdout + file logger (reference `utils/logger.py:7-28`; the port's own
copy of `signal_tpu/utils/logger.py`)."""

import logging
import os
import sys


def setup_logger(name: str, save_dir: str, if_train: bool) -> logging.Logger:
    """A logger writing to stdout and to ``save_dir/{train,test}_log.txt``.
    Handlers from an earlier call in the same process are closed first, so
    repeated runs neither log twice nor leak file handles."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")

    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setLevel(logging.DEBUG)
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fname = "train_log.txt" if if_train else "test_log.txt"
        fh = logging.FileHandler(os.path.join(save_dir, fname), mode="w")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
