"""Logging + model-dir management (port of
``dalle_mtf_tpu/utils/logging_utils.py``).

setup_logging mirrors the reference (utils/utils.py:184-195): a
logs/<config>.log file plus stdout. remove_model_dir is the interactive
``--new`` wipe (utils/utils.py:40-52), of a local directory or a URL's
objects (gs://, memory://: ``data/fs.py``; JAX runs ``gsutil rm -rf`` on
gs:// alone).
"""

from __future__ import annotations

import logging
import os
import sys

from dalle_mtf_tpu_torch.data import fs


def setup_logging(config_name: str, log_dir: str = "logs", rank: int = 0) -> logging.Logger:
    """Log to logs/<config>.log and stdout. Every rank but 0 of a
    multi-process run logs only warnings, to stdout, and writes no file."""
    root = logging.getLogger()
    if rank != 0:
        root.setLevel(logging.WARNING)
        if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
            root.addHandler(logging.StreamHandler(sys.stdout))
        return logging.getLogger("dalle_mtf_tpu_torch")
    os.makedirs(log_dir, exist_ok=True)
    root.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, f"{config_name}.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    # avoid duplicate handlers on repeated setup (tests)
    for h in root.handlers:
        if isinstance(h, logging.FileHandler):
            h.close()
    root.handlers = [
        h for h in root.handlers
        if not isinstance(h, (logging.FileHandler, logging.StreamHandler))
    ]
    root.addHandler(fh)
    root.addHandler(sh)
    return logging.getLogger("dalle_mtf_tpu_torch")


def remove_model_dir(model_dir: str, interactive: bool = True):
    """Wipe a model dir for a fresh run (--new flag, utils/utils.py:40-52)."""
    if interactive:
        answer = input(
            f"Are you sure you want to remove '{model_dir}' to start afresh? [y/N] "
        )
        if answer.strip().lower() not in ("y", "yes"):
            print("aborting")
            sys.exit(0)
    fs.remove_tree(model_dir)
