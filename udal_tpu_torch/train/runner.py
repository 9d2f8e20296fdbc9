"""Batch training runs from an INI file.

Port of ``udal_tpu/train/runner.py``: each section of the file is one
training run (model_name, the train / val file patterns, hparams, epochs),
run in turn through the in-process CLI (``udal_tpu_torch.cli``) with the
JAX runner's argv.
"""

from __future__ import annotations

import configparser
from typing import List, Optional


def run_from_ini(ini_path: str, sections: Optional[List[str]] = None,
                 dry_run: bool = False) -> List[List[str]]:
    """Run (or, with ``dry_run``, only return) the CLI argv of each section."""
    from udal_tpu_torch import cli

    parser = configparser.ConfigParser()
    parser.read(ini_path)
    argvs = []
    for section in (sections or parser.sections()):
        s = parser[section]
        argv = ["train",
                "--model_name", s.get("model_name", "efficientdet-d0"),
                "--model_dir", s.get("model_dir", f"models/{section}"),
                "--train_file_pattern", s.get("train_file_pattern"),
                "--batch_size", s.get("batch_size", "8"),
                "--num_examples_per_epoch", s.get("num_examples_per_epoch", "1024")]
        if s.get("hparams"):
            argv += ["--hparams", s.get("hparams")]
        if s.get("num_epochs"):
            argv += ["--num_epochs", s.get("num_epochs")]
        if s.get("val_file_pattern"):
            argv += ["--val_file_pattern", s.get("val_file_pattern")]
        argvs.append(argv)
        if not dry_run:
            cli.main(argv)
    return argvs
