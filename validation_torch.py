"""Validation/test CLI of the PyTorch/CUDA port (``sast_tpu_torch``).

The port's counterpart of ``validation.py``: loads a checkpoint's weights,
streams the requested split, and prints the Prophesee COCO metrics (one JSON
line on stdout). ``--ckpt`` is a checkpoint directory of the port
(``<workdir>/ckpts`` of ``train_torch.py``: the best step by val/AP, else
the latest) or a reference ``.ckpt``/``.pth`` file, whose parameters AND
BatchNorm running statistics are loaded. It runs on the card unless
``--device cpu`` is given. Reading a dataset needs ``h5py``.

    python validation_torch.py --dataset gen1 --size base --data /data/gen1 \
        --ckpt runs/gen1_base/ckpts --split test
"""

from __future__ import annotations

import argparse
import json
import sys

from train_torch import parse_overrides


def main(argv=None, eval_batches=None):
    """Returns ``(metrics, trainer)``. ``eval_batches`` (an iterable of
    batches in the layout of ``data/batch.assemble_batch``) replaces the
    dataset's split; ``--data`` is then not read."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", choices=("gen1", "gen4"), default="gen1")
    ap.add_argument("--size", choices=("tiny", "small", "base", "large"), default="base")
    ap.add_argument("--data", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory of the port, or a reference .ckpt/.pth file")
    ap.add_argument("--split", choices=("val", "test"), default="val")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE")
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--sparse-kernel", action=argparse.BooleanOptionalAction, default=False,
                    help="evaluate through the window-skipping block kernel")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--workdir", default="runs/validation",
                    help="where the trainer that evaluates keeps its log")
    ap.add_argument("--device-cache", action="store_true",
                    help="keep the split's event representations on the card and gather "
                    "clips there (sast_tpu_torch/data/device_cache.py)")
    args = ap.parse_args(argv)

    from sast_tpu_torch.checkpoint.io import CheckpointManager
    from sast_tpu_torch.checkpoint.torch_convert import load_torch_checkpoint
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.module import DataModule
    from sast_tpu_torch.training.loop import Trainer

    overrides = parse_overrides(args.overrides)
    overrides.setdefault("dataset.path", args.data)
    # As validation.py: a lower confidence threshold than the train-time
    # postprocessing (the reference's val config: 0.001 against 0.01).
    overrides.setdefault("model.postprocess.confidence_threshold", 0.001)
    cfg = get_config(args.dataset, args.size, **overrides)

    trainer = Trainer(cfg, workdir=args.workdir, val_every=None,
                      sparse_kernel_eval=args.sparse_kernel, device=args.device)
    if args.ckpt.endswith((".ckpt", ".pth")):
        load_torch_checkpoint(args.ckpt, trainer.model)
        trainer.state.ema_params = None  # a reference file holds the weights to evaluate
    else:
        CheckpointManager(args.ckpt).restore_weights(trainer.state)

    if eval_batches is None and args.device_cache:
        from sast_tpu_torch.data.device_cache import DeviceCachedEvalStream

        eval_batches = DeviceCachedEvalStream(cfg, args.split, device=trainer.device)
    elif eval_batches is None:
        eval_batches = DataModule(cfg).eval_batches(args.split)
    metrics = trainer.validate(eval_batches, max_batches=args.max_batches)
    for k, v in metrics.items():
        print(f"{k:12s} | {v * 100:.4f}%", file=sys.stderr)
    print(json.dumps(metrics))
    return metrics, trainer


if __name__ == "__main__":
    main()
