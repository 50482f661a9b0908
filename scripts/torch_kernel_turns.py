#!/usr/bin/env python3
"""Time the hand-written kernels of one checkout of the PyTorch/CUDA port on the card.

For comparing two checkouts (a parent commit and its change) in turns in one
call on one card, one process each, e.g. parent, change, change, parent:

    python3 scripts/torch_kernel_turns.py --root PATH --tag parent \\
        --out chiprun_out/kernel_turns.jsonl

imports ``sast_tpu_torch`` from PATH (default: this checkout), builds its
libraries, and prints one JSON line (appended to ``--out`` too): the card's
name and power limit, the registers and spills of every kernel this process
built, then per kernel and shape the card time in ms (CUDA events, launches
queued ahead, ``chip_smoke.cuda_ms``), the largest error against the
kernel's plain version on the same inputs, and a digest of the kernel's
outputs (the same digest on two trees means the same bits). Kernel C
(``greedy_keep``) at (4, 1000) and (36, 1000) clustered candidates, also per
launch where its kernels live in the ``nk`` namespace; kernels D
(``fused_window_block``), E (``sparse_window_block``) and F
(``sparse_window_block_looped``) at the four gen4-base b4 stage shapes (M x
60 tokens x C), G (``sparse_block_mlp_bwd``) and H
(``sparse_block_attn_bwd``) at the four B 12 training stage shapes, bf16
and fp32 weights, window density 0.4; kernel B (``density_ratio``) at the
b4 stem input, on the card, per eager call and per launch (every kernel the
call puts on the card). The inputs come from fixed seeds and use only the
wrappers' public arguments, which both sides of a comparison share.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BLOCK_SHAPES = ((1024, 64, 2), (256, 128, 4), (64, 256, 8), (16, 512, 16))  # M, C, heads
TRAIN_BLOCK_SHAPES = tuple((3 * M, C, heads) for M, C, heads in BLOCK_SHAPES)  # B 12
DENSITY_SHAPE = (4, 384, 640, 20)  # the stem input of the gen4-base b4 step
HW = 60
DENSITY = 0.4


def block_inputs(torch, np, M, C, heads, wdt, seed):
    """Tokens, masks and weights of one attention layer: window density 0.4,
    token density 0.5 inside kept windows, LayerScale of order 1."""
    rng = np.random.RandomState(seed)
    inner = C * 4 * 2 // 3 // 32 * 32
    win = rng.rand(M) < DENSITY
    win[0] = True
    tok = (rng.rand(M, HW) < 0.5) & win[:, None]
    tok[0, HW // 2] = True

    def mat(k, n):  # (out, in) storage, handed over as the (in, out) view
        return torch.from_numpy((rng.randn(n, k) / np.sqrt(k)).astype(np.float32)).to(
            "cuda", wdt).t()

    def vec(n, scale, shift=0.0):
        return torch.from_numpy((shift + scale * rng.randn(n)).astype(np.float32)).cuda()

    params = {
        "ln2_scale": vec(C, 0.1, 1.0), "ln2_bias": vec(C, 0.1),
        "wqkv": mat(C, 3 * C), "bqkv": vec(3 * C, 0.1),
        "wproj": mat(C, C), "bproj": vec(C, 0.1), "ls1": vec(C, 0.1, 1.0),
        "wglu": mat(C, 2 * inner), "bglu": vec(2 * inner, 0.1),
        "wout": mat(inner, C), "bout": vec(C, 0.1), "ls2": vec(C, 0.1, 1.0),
    }
    y = torch.from_numpy(rng.randn(M, HW, C).astype(np.float32)).to("cuda", wdt)
    win &= tok.any(-1)
    return y, torch.from_numpy(tok).cuda(), torch.from_numpy(win).cuda(), params


def nms_inputs(torch, np, n, k=1000):
    """chip_smoke.py's clustered, score-sorted candidates of ``n`` frames."""
    rng = np.random.RandomState(2)
    centers = rng.rand(n, 12, 2) * 600
    idx = rng.randint(0, 12, (n, k))
    xy = centers[np.arange(n)[:, None], idx] + rng.randn(n, k, 2) * 15
    wh = 10 + rng.rand(n, k, 2) * 60
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    sc = np.sort(rng.rand(n, k).astype(np.float32), axis=-1)[:, ::-1].copy()
    sc[:, -100:] = 0.0
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(sc).cuda()


def digest(*tensors) -> str:
    """Short hash of the tensors' bytes (dicts by sorted key)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        for v in ([t[k] for k in sorted(t)] if isinstance(t, dict) else [t]):
            h.update(v.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def max_err(got, ref) -> float:
    """Largest absolute difference over a tensor, a dict or a tuple of them."""
    if isinstance(got, (tuple, list)):
        return max(max_err(a, b) for a, b in zip(got, ref))
    if isinstance(got, dict):
        return max(max_err(got[k], ref[k]) for k in ref)
    return (got.float() - ref.float()).abs().max().item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose sast_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name of the checkout in the output")
    ap.add_argument("--out", default=None, help="file the JSON line is appended to")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_turns: needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sast_tpu_torch import build
    from sast_tpu_torch.ops import block, density, fused_block, nms_keep, sparse_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = build.build()
    names = ("greedy_keep", "density_ratio", "fused_window_block", "sparse_window_block",
             "sparse_window_block_looped", "sparse_block_mlp_bwd", "sparse_block_attn_bwd")
    record = dict(tag=args.tag, root=args.root, card=card, build_s=time.perf_counter() - t0,
                  ptxas=smoke.ptxas_lines(logs, tuple(logs)), **{n: {} for n in names})
    for n in (4, 36):
        boxes, scores = nms_inputs(torch, np, n)
        call = lambda: nms_keep.greedy_keep(boxes, scores, 0.45)
        exact = torch.equal(call(), nms_keep.greedy_keep_plain(boxes, scores, 0.45))
        record["greedy_keep"][f"{n}x1000"] = dict(
            ms=smoke.cuda_ms(torch, call, ahead=True), exact=exact,
            per_launch_us=smoke.launch_us(torch, call, "nk"))
    x = torch.from_numpy(np.random.RandomState(0).poisson(0.1, DENSITY_SHAPE).clip(0, 10)
                         .astype(np.uint8)).cuda()
    call = lambda: density.density_ratio(x)
    record["density_ratio"]["b4"] = dict(
        ms=smoke.cuda_ms(torch, call, ahead=True), call_ms=smoke.cuda_ms(torch, call),
        exact=torch.equal(call(), density.density_ratio_plain(x)), digest=digest(call()),
        per_launch_us=smoke.launch_us(torch, call, None))
    with torch.no_grad():
        for si, (M, C, heads) in enumerate(BLOCK_SHAPES):
            for wdt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                y, tok, win, params = block_inputs(torch, np, M, C, heads, wdt, 300 + si)
                dh = C // heads
                calls = dict(
                    fused_window_block=(
                        lambda: fused_block.fused_window_block(y, tok, params, heads, dh),
                        lambda: fused_block.fused_block_plain(y, tok, params, heads, dh)),
                    sparse_window_block=(
                        lambda: sparse_block.sparse_window_block(y, tok, win, params, heads, dh),
                        lambda: sparse_block.sparse_window_block_plain(y, tok, win, params,
                                                                       heads, dh)),
                    sparse_window_block_looped=(
                        lambda: sparse_block.sparse_window_block_looped(y, tok, win, params,
                                                                        heads, dh),
                        lambda: sparse_block.sparse_window_block_plain(y, tok, win, params,
                                                                       heads, dh)),
                )
                for name, (kernel, plain) in calls.items():
                    got = kernel()
                    record[name][f"stage{si + 1}_{kind}"] = dict(
                        ms=smoke.cuda_ms(torch, kernel, iters=10, ahead=True),
                        max_abs_err=max_err(got, plain()), digest=digest(got))
        for si, (M, C, heads) in enumerate(TRAIN_BLOCK_SHAPES):
            for wdt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                y, tok, win, params = block_inputs(torch, np, M, C, heads, wdt, 400 + si)
                dh = C // heads
                g = torch.from_numpy(np.random.RandomState(si).randn(*y.shape).astype(np.float32)
                                     ).to("cuda", wdt)
                work = block.work_list(win)
                _, h1 = sparse_block.sparse_window_block_plain(y, tok, win, params, heads, dh,
                                                               save_h1=True)
                gh1, _ = sparse_block.sparse_block_mlp_bwd_plain(h1, tok, work, params, g)
                calls = dict(
                    sparse_block_mlp_bwd=(
                        lambda: sparse_block.sparse_block_mlp_bwd(h1, tok, work, params, g,
                                                                  heads, dh),
                        lambda: sparse_block.sparse_block_mlp_bwd_plain(h1, tok, work, params,
                                                                        g)),
                    sparse_block_attn_bwd=(
                        lambda: sparse_block.sparse_block_attn_bwd(y, tok, work, params, gh1,
                                                                   heads, dh),
                        lambda: sparse_block.sparse_block_attn_bwd_plain(y, tok, work, params,
                                                                         gh1, heads, dh)),
                )
                for name, (kernel, plain) in calls.items():
                    got = kernel()
                    record[name][f"stage{si + 1}_{kind}"] = dict(
                        ms=smoke.cuda_ms(torch, kernel, iters=10, ahead=True),
                        max_abs_err=max_err(got, plain()), digest=digest(*got))
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
