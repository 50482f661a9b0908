"""Training CLI of the PyTorch/CUDA port (``sast_tpu_torch``).

The port's counterpart of ``train.py``: builds the resolved config from the
dataset/size presets plus dotted overrides, wires the data module, and runs
the training loop with periodic Prophesee validation (on the test split, as
``train.py`` does) and best-AP checkpointing under ``<workdir>/ckpts``. It
runs on the card unless ``--device cpu`` is given. Reading a dataset needs
``h5py``.

Examples:
    python train_torch.py --dataset gen1 --size base --data /data/gen1 \
        --workdir runs/gen1_base
    python train_torch.py --dataset gen4 --size base --data /data/gen4 \
        --sparse-kernel-train --resume

Refused, since the port has no counterpart yet: Weights & Biases
(``--wandb``, ``--wandb-runpath``, ``--resume-wandb-artifact``), the
on-device dataset cache (``--device-cache``), profiler traces
(``--profile-steps``) and a multi-process world (``WORLD_SIZE`` above 1).
"""

from __future__ import annotations

import argparse
import ast
import os
import sys


def parse_overrides(pairs):
    """``["a.b=1", ...]`` -> ``{"a.b": 1, ...}``; values parse as Python
    literals where they can, else stay strings."""
    out = {}
    for pair in pairs or []:
        key, sep, value = pair.partition("=")
        if sep != "=":
            raise ValueError(f"override must be key=value: {pair}")
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


_REFUSED = {
    "wandb": "Weights & Biases logging",
    "wandb_runpath": "Weights & Biases logging",
    "resume_wandb_artifact": "resuming from a Weights & Biases artifact",
    "device_cache": "the on-device dataset cache",
    "profile_steps": "profiler traces",
}


def refuse_unported(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    for name, what in _REFUSED.items():
        if getattr(args, name, None):
            ap.error(f"--{name.replace('_', '-')}: {what} is not ported to sast_tpu_torch yet")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        ap.error("a multi-process world (WORLD_SIZE > 1) is not ported to sast_tpu_torch yet")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", choices=("gen1", "gen4"), default="gen1")
    ap.add_argument("--size", choices=("tiny", "small", "base", "large"), default="base")
    ap.add_argument("--data", required=True, help="preprocessed dataset root")
    ap.add_argument("--workdir", default="runs/default")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--resume-only-weights", action="store_true")
    ap.add_argument("--sparse-kernel-train", action="store_true",
                    help="train through the window-skipping block kernel and its "
                    "hand-written backward (requires drop_path/drop_mlp == 0)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--val-every", type=int, default=10_000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # train.py's options that the port does not have yet: refused by name.
    ap.add_argument("--wandb", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--wandb-runpath", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume-wandb-artifact", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device-cache", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--profile-steps", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    refuse_unported(ap, args)

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.module import DataModule
    from sast_tpu_torch.training.loop import Trainer

    overrides = parse_overrides(args.overrides)
    overrides.setdefault("dataset.path", args.data)
    cfg = get_config(args.dataset, args.size, **overrides)
    print(f"device {args.device}  lr {cfg.training.learning_rate:.3e}", file=sys.stderr)

    dm = DataModule(cfg)
    trainer = Trainer(cfg, workdir=args.workdir, log_every=args.log_every,
                      val_every=args.val_every, sparse_kernel_train=args.sparse_kernel_train,
                      device=args.device)
    trainer.maybe_resume(args.resume or args.resume_only_weights,
                         weights_only=args.resume_only_weights)
    # As train.py: validation during fit streams the *test* split.
    return trainer.fit(dm.train_batches(seed=cfg.training.seed or 0),
                       eval_loader_fn=lambda: dm.eval_batches("test"),
                       max_steps=args.max_steps)


if __name__ == "__main__":
    main()
