"""Training CLI of the PyTorch/CUDA port (``sast_tpu_torch``).

The port's counterpart of ``train.py``: builds the resolved config from the
dataset/size presets plus dotted overrides, wires the data module, and runs
the training loop with periodic Prophesee validation (on the test split, as
``train.py`` does) and best-AP checkpointing under ``<workdir>/ckpts``. It
runs on the card unless ``--device cpu`` is given. Reading a dataset needs
``h5py``.

Data parallel: launched by ``torchrun --nproc-per-node N``, each process
takes card ``LOCAL_RANK`` (``nccl``; ``gloo`` with ``--device cpu``), feeds
``batch_size_train / N`` lanes, and the peak learning rate scales with the
batch as ``train.py`` scales it: ``lr * sqrt(batch_size_train * N / 8)``.
``--device-cache`` keeps the train and test splits' event representations
on the card (one process); ``--profile-steps FIRST:LAST`` records a
``torch.profiler`` trace of those steps into ``<workdir>/trace``. On a
card the train and eval steps run as captured CUDA graphs, as ``train.py``
runs its jitted steps (a layer that chooses its branch on the card as a
conditional node of the graph); ``--eager`` runs them eagerly (a gloo world
needs it).

Examples:
    python train_torch.py --dataset gen1 --size base --data /data/gen1 \
        --workdir runs/gen1_base
    python train_torch.py --dataset gen4 --size base --data /data/gen4 \
        --sparse-kernel-train --resume
    torchrun --nproc-per-node 4 train_torch.py --dataset gen4 --size base \
        --data /data/gen4 --profile-steps 100:102

Refused, since the port has no counterpart: Weights & Biases (``--wandb``,
``--wandb-runpath``, ``--resume-wandb-artifact``).
"""

from __future__ import annotations

import argparse
import ast
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
}


def refuse_unported(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    for name, what in _REFUSED.items():
        if getattr(args, name, None):
            ap.error(f"--{name.replace('_', '-')}: {what} is not ported to sast_tpu_torch")


def parse_profile_steps(text):
    """``"FIRST:LAST"`` (or ``"N"``) -> ``(first, last)``; None stays None."""
    if not text:
        return None
    first, _, last = text.partition(":")
    return int(first), int(last or first)


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
    ap.add_argument("--device-cache", action="store_true",
                    help="keep the train and test splits' event representations on the card "
                    "and gather clips there (one process, flip-only augmentation, the split "
                    "must fit; sast_tpu_torch/data/device_cache.py)")
    ap.add_argument("--eager", action="store_true",
                    help="run the train and eval steps eagerly instead of as captured CUDA "
                    "graphs (Trainer(graph=False)); a gloo world trains so")
    ap.add_argument("--profile-steps", metavar="FIRST:LAST", default=None,
                    help="record a torch.profiler trace of these training steps (inclusive) "
                    "into <workdir>/trace; view with TensorBoard or Perfetto")
    # train.py's options that the port has no counterpart for: refused by name.
    ap.add_argument("--wandb", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--wandb-runpath", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume-wandb-artifact", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    refuse_unported(ap, args)
    profile_steps = parse_profile_steps(args.profile_steps)

    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.module import DataModule
    from sast_tpu_torch.parallel.mesh import (
        make_mesh,
        maybe_initialize_distributed,
        process_shard_info,
    )
    from sast_tpu_torch.training.loop import Trainer
    from sast_tpu_torch.training.optimizer import scale_lr_for_global_batch

    # A torchrun world starts its process group before any use of the card.
    maybe_initialize_distributed(args.device)
    rank, world = process_shard_info()

    overrides = parse_overrides(args.overrides)
    overrides.setdefault("dataset.path", args.data)
    cfg = get_config(args.dataset, args.size, **overrides)
    # train.py's rule, as it stands: over a world, lr = base *
    # sqrt(batch_size_train * world / 8). (train.py counts batch_size_train
    # lanes per process; both DataModules give each process
    # batch_size_train / world of them.)
    lr = (scale_lr_for_global_batch(cfg.training.learning_rate,
                                    cfg.training.batch_size_train * world)
          if world > 1 else cfg.training.learning_rate)
    mesh = make_mesh(args.device if args.device == "cpu" else None) if world > 1 else None
    if rank == 0:
        print(f"rank {rank}/{world}  device {mesh.device if mesh else args.device}  lr {lr:.3e}"
              + ("  (data parallel)" if mesh else ""), file=sys.stderr)

    trainer = Trainer(cfg, workdir=args.workdir, log_every=args.log_every,
                      val_every=args.val_every, sparse_kernel_train=args.sparse_kernel_train,
                      learning_rate=lr, device=args.device, mesh=mesh, graph=not args.eager)
    trainer.maybe_resume(args.resume or args.resume_only_weights,
                         weights_only=args.resume_only_weights)
    # As train.py: validation during fit streams the *test* split.
    seed = cfg.training.seed or 0
    if args.device_cache:
        from sast_tpu_torch.data.device_cache import (
            DeviceCachedEvalStream,
            DeviceCachedTrainStream,
        )

        train_batches = DeviceCachedTrainStream(cfg, seed=seed, device=trainer.device)
        eval_cache = DeviceCachedEvalStream(cfg, "test", device=trainer.device)
        eval_loader_fn = lambda: eval_cache  # noqa: E731
    else:
        dm = DataModule(cfg, rank=rank, world_size=world)
        train_batches = dm.train_batches(seed=seed)
        eval_loader_fn = lambda: dm.eval_batches("test")  # noqa: E731
    return trainer.fit(train_batches, eval_loader_fn=eval_loader_fn, max_steps=args.max_steps,
                       profile_steps=profile_steps)


if __name__ == "__main__":
    main()
