"""Export a trained checkpoint of the PyTorch/CUDA port as a deployable
streaming-inference artifact (the port's counterpart of
scripts/export_model.py).

Loads weights (the port's checkpoint directory, ``checkpoint/io.py``, where
the EMA copy is deployed when it has one; or a reference ``.ckpt`` /
``.pth``, parameters and BatchNorm statistics), builds the serving step
(raw events -> detections, ``sast_tpu_torch/serving.py``) on ``--device``,
and traces it with ``torch.export`` into ``<out>/streaming_step.pt2``, which
``sast_tpu_torch.export.ExportedStreamingDetector`` runs without the model
code or config (``sast_tpu_torch/export.py``). The artifact runs on the
device it was exported on, under the torch version that wrote it.

    python scripts/export_model_torch.py --dataset gen1 --size base \\
        --ckpt runs/g1b/ckpts --out artifacts/g1b [--max-events 200000] \\
        [--num-streams 1] [--set KEY=VALUE ...] [--device cuda]

Refused, since the port has no counterpart: ``--platforms`` and
``--allow-tpu-kernels`` (an artifact holds the port's operators, which
launch the card's kernels or run their plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_REFUSED = {
    "platforms": "lowering for several platforms",
    "allow_tpu_kernels": "serializing the TPU's Pallas kernels",
}


def main(argv=None) -> str:
    """Parse ``argv``, export, and return the artifact's path."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", choices=("gen1", "gen4"), default="gen1")
    ap.add_argument("--size", choices=("tiny", "small", "base", "large"), default="base")
    ap.add_argument("--ckpt", required=True,
                    help="the port's checkpoint directory, or a reference .ckpt/.pth file")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--max-events", type=int, default=200_000,
                    help="static per-frame event budget")
    ap.add_argument("--num-streams", type=int, default=1,
                    help="parallel stream lanes baked into the artifact")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # scripts/export_model.py's options that the port has no counterpart for.
    ap.add_argument("--platforms", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--allow-tpu-kernels", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for name, what in _REFUSED.items():
        if getattr(args, name):
            ap.error(f"--{name.replace('_', '-')}: {what} is not ported to sast_tpu_torch")

    import torch

    from sast_tpu_torch.checkpoint.io import CheckpointManager
    from sast_tpu_torch.checkpoint.torch_convert import load_torch_checkpoint
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.export import ARTIFACT_NAME, export_streaming_detector
    from sast_tpu_torch.models.detector import YoloXDetector, resolve_device
    from sast_tpu_torch.serving import StreamingDetector
    from train_torch import parse_overrides

    overrides = parse_overrides(args.overrides)
    # Deployment uses the validation confidence threshold by default
    # (reference config/val.yaml), as scripts/export_model.py does.
    overrides.setdefault("model.postprocess.confidence_threshold", 0.001)
    cfg = get_config(args.dataset, args.size, **overrides)
    device = resolve_device(args.device)

    model = YoloXDetector(cfg.model)
    if args.ckpt.endswith((".ckpt", ".pth")):
        load_torch_checkpoint(args.ckpt, model)
    else:
        mgr = CheckpointManager(args.ckpt)
        step = mgr.best_step()
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to export in {args.ckpt}")
        payload = torch.load(mgr.path(step), map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        if payload["ema"] is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(payload["ema"][name])

    det = StreamingDetector(cfg, model, max_events=args.max_events,
                            num_streams=args.num_streams, device=device)
    blob = export_streaming_detector(det, path=args.out)
    path = os.path.join(args.out, ARTIFACT_NAME)
    print(f"wrote {path} ({len(blob) / 1e6:.1f} MB, max_events={args.max_events}, "
          f"num_streams={args.num_streams}, device={device}, torch {torch.__version__})")
    return path


if __name__ == "__main__":
    main()
