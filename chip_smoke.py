#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sast_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. Phases, each fatal on failure:

1. Print the card's name and power limit; build the three kernels from
   ``sast_tpu_torch/csrc`` (one nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, TF32
   off, at the gen4-base b4 serving shapes, and time kernel, plain version,
   bound and library call.
3. Drive the port's main path: ``StreamingDetector`` at gen4-base width
   (384x640 model resolution, 20 channels, dims 64/128/256/512, bf16),
   ``num_streams=4``, seeded random weights, 8 frames of seeded synthetic
   events with one lane reset midway; the launch counters must show the
   stem and NMS kernels on every frame. Then the same weights with the
   stem/density fusion off, which puts the density kernel on the path and
   must give the same detections. Steady-state ms/step with CUDA events.
4. Hold the whole path on the card (kernels, fp32, TF32 off) against the
   same port on the CPU (plain versions) at gen4-base B=1 for 2 frames.

Prints the kernel table as one JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Longer output (build
logs, profiler table, all measurements) goes to ``chiprun_out/``.
Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DEVICE = "cuda"
KERNEL_SHAPE = (4, 384, 640, 20)  # the stem input of the gen4-base b4 step
FRAMES = 8
STREAMS = 4
EVENTS_PER_FRAME = 200_000  # StreamingDetector's default budget
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_events(rng, n, h, w, frame):
    t = rng.randint(0, 50_000, n)
    t.sort()
    return dict(
        x=rng.randint(0, w, n), y=rng.randint(0, h, n), p=rng.randint(0, 2, n),
        t=t + frame * 50_000,
    )


def kernel_inputs(torch, np):
    """Two (4, 384, 640, 20) uint8 inputs at the main path's shape: Poisson
    counts at the serving protocol's ~90% zeros, and a ragged one (empty
    except a dense band, edge columns and corner tiles up to 255)."""
    rng = np.random.RandomState(0)
    shape = KERNEL_SHAPE
    main = rng.poisson(0.1, shape).clip(0, 10).astype(np.uint8)
    ragged = np.zeros(shape, np.uint8)
    B, H, W, C = shape
    ragged[0, H // 4 : H // 4 + 40] = rng.randint(0, 3, (40, W, C))
    ragged[1, :, :3] = 255
    ragged[2, -32:, -32:] = rng.randint(0, 256, (32, 32, C))
    ragged[3, :7, :] = rng.poisson(2.0, (7, W, C)).clip(0, 255)
    return [torch.from_numpy(a).to(DEVICE) for a in (main, ragged)]


def phase_kernels(torch, np):
    import torch.nn.functional as F

    from sast_tpu_torch.ops import density, nms_keep, stem_conv

    results = {}
    xs = kernel_inputs(torch, np)
    B, H, W, C = xs[0].shape
    gen = torch.Generator().manual_seed(1)
    w32 = (torch.randn(64, C, 7, 7, generator=gen) * 0.05).to(DEVICE)

    # Kernel A: both dtypes, with and without density, both inputs.
    for dt in (torch.float32, torch.bfloat16):
        w = w32.to(dt)
        for with_density in (False, True):
            for i, x in enumerate(xs):
                got = stem_conv.stem_conv7x4(x, w, with_density)
                ref = stem_conv.stem_conv7x4_plain(x, w, with_density)
                y, yr = (got[0], ref[0]) if with_density else (got, ref)
                scale = yr.float().abs().max().item()
                err = (y.float() - yr.float()).abs().max().item()
                # fp32: 980-term fp32 sums in another order; bf16: both
                # round an fp32 sum to bf16, so up to two bf16 ulps at max|y|.
                tol = (1e-5 if dt == torch.float32 else 2 ** -7) * max(scale, 1.0)
                if not err <= tol:
                    fail(f"stem kernel {dt} density={with_density} input {i}: "
                         f"max err {err} > {tol}")
                if with_density and not torch.equal(got[1], ref[1]):
                    fail(f"stem kernel density ratio differs ({dt}, input {i})")
                log(f"kernel stem_conv7x4 {dt} density={with_density} input {i}: "
                    f"max_abs_err {err:.3e} (max|y| {scale:.3f}, tol {tol:.3e})")
                results[f"stem_err_{dt}_{with_density}_{i}"] = err
    x = xs[0]
    wb = w32.to(torch.bfloat16)
    ms = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, wb, True))
    plain = cuda_ms(torch, lambda: stem_conv.stem_conv7x4_plain(x, wb, True), iters=5)
    ms_nd = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, wb, False))
    ms_fp32 = cuda_ms(torch, lambda: stem_conv.stem_conv7x4(x, w32, True))
    xp = F.pad(x.to(torch.bfloat16).permute(0, 3, 1, 2), (3, 3, 3, 3), mode="replicate")
    lib = cuda_ms(torch, lambda: F.conv2d(xp, wb, stride=4))
    y_bytes = B * (H // 4) * (W // 4) * 64
    a_bytes = x.numel() + wb.numel() * 2 + y_bytes * 2 + B * 4 * C * 4
    a_flops = 2.0 * y_bytes * 7 * 7 * C
    a_bound, a_by = bound_ms(a_bytes, a_flops, "bf16")
    err_a = max(v for k, v in results.items() if k.startswith("stem_err_torch.bfloat16"))
    log(f"kernel stem_conv7x4 bf16+density {ms:.4f} ms, no density {ms_nd:.4f} ms, "
        f"fp32+density {ms_fp32:.4f} ms, plain {plain:.4f} ms, F.conv2d {lib:.4f} ms, "
        f"bound {a_bound:.4f} ms ({a_by}: {a_bytes / 1e6:.1f} MB, {a_flops / 1e9:.2f} GFLOP)")
    stem = dict(name="stem_conv7x4", route="cuda", source="sast_tpu_torch/csrc/stem_conv.cu",
                replaces="sast_tpu/ops/pallas/stem_conv.py:604", launches=None,
                max_abs_err=err_a, ms=ms, plain_ms=plain, bound_ms=a_bound, bound_by=a_by,
                library_ms=lib, ms_no_density=ms_nd, ms_fp32=ms_fp32)

    # Kernel B.
    for i, xi in enumerate(xs):
        if not torch.equal(density.density_ratio(xi), density.density_ratio_plain(xi)):
            fail(f"density kernel differs from its plain version on input {i}")
    ms_b = cuda_ms(torch, lambda: density.density_ratio(x))
    plain_b = cuda_ms(torch, lambda: density.density_ratio_plain(x), iters=5)
    b_bound, b_by = bound_ms(x.numel() + B * 4 * C * 4, 2.0 * x.numel(), "fp32")
    log(f"kernel density_ratio {ms_b:.4f} ms, plain {plain_b:.4f} ms, "
        f"bound {b_bound:.4f} ms ({b_by}); exact on both inputs")
    dens = dict(name="density_ratio", route="cuda", source="sast_tpu_torch/csrc/density.cu",
                replaces="sast_tpu/ops/pallas/density.py:168", launches=None,
                max_abs_err=0.0, ms=ms_b, plain_ms=plain_b, bound_ms=b_bound,
                bound_by=b_by, library_ms=None)

    # Kernel C: (4, 1000) clustered, score-sorted candidates.
    rng = np.random.RandomState(2)
    n, k = 4, 1000
    centers = rng.rand(n, 12, 2) * 600
    idx = rng.randint(0, 12, (n, k))
    xy = centers[np.arange(n)[:, None], idx] + rng.randn(n, k, 2) * 15
    wh = 10 + rng.rand(n, k, 2) * 60
    boxes = torch.from_numpy(
        np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)).to(DEVICE)
    sc = np.sort(rng.rand(n, k).astype(np.float32), axis=-1)[:, ::-1].copy()
    sc[:, -100:] = 0.0
    scores = torch.from_numpy(sc).to(DEVICE)
    keep = nms_keep.greedy_keep(boxes, scores, 0.45)
    keep_ref = nms_keep.greedy_keep_plain(boxes, scores, 0.45)
    if not torch.equal(keep, keep_ref):
        fail(f"greedy keep kernel differs at {int((keep != keep_ref).sum())} candidates")
    ms_c = cuda_ms(torch, lambda: nms_keep.greedy_keep(boxes, scores, 0.45))
    plain_c = cuda_ms(torch, lambda: nms_keep.greedy_keep_plain(boxes, scores, 0.45),
                      iters=3, warmup=1)
    # Work this data needs: one IoU test (about 12 fp32 ops) per kept
    # earlier box for every valid candidate.
    kept_before = torch.cumsum(keep_ref.int(), dim=1) - keep_ref.int()
    tests = float((kept_before * (scores > 0)).sum())
    c_bound, c_by = bound_ms(boxes.numel() * 4 + scores.numel() * 4 + keep.numel(),
                             12.0 * tests, "fp32")
    log(f"kernel greedy_keep {ms_c:.4f} ms, plain {plain_c:.4f} ms, bound {c_bound:.6f} ms "
        f"({c_by}); exact; kept {int(keep.sum())} of {int((scores > 0).sum())}")
    nmsk = dict(name="greedy_keep", route="cuda", source="sast_tpu_torch/csrc/nms_keep.cu",
                replaces="sast_tpu/ops/pallas/nms_keep.py:79", launches=None,
                max_abs_err=0.0, ms=ms_c, plain_ms=plain_c, bound_ms=c_bound,
                bound_by=c_by, library_ms=None)
    return [stem, dens, nmsk]


def reset_counters():
    from sast_tpu_torch.ops import density, nms_keep, stem_conv

    stem_conv.stem_conv7x4.launches = 0
    density.density_ratio.launches = 0
    nms_keep.greedy_keep.launches = 0


def read_counters():
    from sast_tpu_torch.ops import density, nms_keep, stem_conv

    return dict(stem_conv7x4=stem_conv.stem_conv7x4.launches,
                density_ratio=density.density_ratio.launches,
                greedy_keep=nms_keep.greedy_keep.launches)


def phase_serving(torch, np, card):
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.models.detector import YoloXDetector, build_detector
    from sast_tpu_torch.serving import StreamingDetector

    cfg = get_config("gen4", "base")
    bb = cfg.model.backbone
    log(f"gen4-base: model {bb.in_res_hw}, native {cfg.dataset.resolution_hw}, dims "
        f"{bb.stage_dims}, partition {bb.attention.partition_size}, "
        f"{cfg.model.compute_dtype}, {STREAMS} streams")
    model = build_detector(cfg.model, seed=0, device=DEVICE)
    det = StreamingDetector(cfg, model, max_events=EVENTS_PER_FRAME, num_streams=STREAMS,
                            device=DEVICE)
    h, w = cfg.dataset.resolution_hw
    rng = np.random.RandomState(7)
    frames = [[synthetic_events(rng, EVENTS_PER_FRAME - 1000 * s, h, w, f)
               for s in range(STREAMS)] for f in range(FRAMES)]
    resets = [np.array([f == FRAMES // 2 and s == 2 for s in range(STREAMS)])
              for f in range(FRAMES)]
    pp = cfg.model.postprocess

    reset_counters()
    outs = [det.process_batch(frames[f], reset=resets[f]) for f in range(FRAMES)]
    torch.cuda.synchronize()
    counts = read_counters()
    log(f"main path launches over {FRAMES} frames: {counts}")
    if counts["stem_conv7x4"] < FRAMES or counts["greedy_keep"] < FRAMES:
        fail(f"main path did not launch the stem and NMS kernels on every frame: {counts}")
    for f, out in enumerate(outs):
        for key, shape in (("boxes", (STREAMS, pp.max_detections, 4)),
                           ("scores", (STREAMS, pp.max_detections)),
                           ("valid", (STREAMS, pp.max_detections))):
            if out[key].shape != shape:
                fail(f"frame {f} {key} shape {out[key].shape} != {shape}")
        if out["valid"].dtype != bool or not np.isfinite(out["boxes"]).all() \
                or not np.isfinite(out["scores"]).all():
            fail(f"frame {f}: non-finite outputs or a non-bool valid mask")
        if (out["scores"][~out["valid"]] != 0).any() or (out["classes"][~out["valid"]] != -1).any():
            fail(f"frame {f}: invalid slots are not zeroed")
        log(f"frame {f}: valid per lane {out['valid'].sum(1).tolist()}, "
            f"selected tokens {out['selected_tokens'].tolist()}")

    # The density kernel on the path: fusion off, same weights, same frames.
    cfg_nf = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(bb, fuse_stem_density=False)))
    model_nf = YoloXDetector(cfg_nf.model)
    model_nf.load_state_dict(model.state_dict())
    det_nf = StreamingDetector(cfg_nf, model_nf, max_events=EVENTS_PER_FRAME,
                               num_streams=STREAMS, device=DEVICE)
    det.reset()
    reset_counters()
    outs_nf = [det_nf.process_batch(frames[f]) for f in range(2)]
    torch.cuda.synchronize()
    counts_nf = read_counters()
    log(f"fusion-off launches over 2 frames: {counts_nf}")
    if counts_nf["density_ratio"] < 2 or counts_nf["stem_conv7x4"] < 2:
        fail(f"fusion-off path did not launch the density and stem kernels: {counts_nf}")
    for f in range(2):
        ref = det.process_batch(frames[f])
        for key in ("boxes", "scores", "classes", "valid", "selected_tokens"):
            if not np.array_equal(ref[key], outs_nf[f][key]):
                fail(f"fused and standalone density paths differ at frame {f} {key}")
    log("fused and standalone density paths give identical detections")

    # Steady state: the device step alone (CUDA events) and the whole
    # process_batch (host packing, upload, step, download).
    from sast_tpu_torch.packing import pack_event_batch

    packed, n = pack_event_batch(frames[0], STREAMS, EVENTS_PER_FRAME)
    pk, nk = torch.from_numpy(packed).to(DEVICE), torch.from_numpy(n).to(DEVICE)
    no_reset = torch.zeros(STREAMS, dtype=torch.bool, device=DEVICE)
    step_ms = cuda_ms(torch, lambda: det.step(pk, nk, no_reset), iters=30, warmup=5)
    t0 = time.perf_counter()
    for f in range(FRAMES):
        det.process_batch(frames[f])
    e2e_ms = (time.perf_counter() - t0) / FRAMES * 1e3
    log(f"serving step gen4-base b{STREAMS} on {card}: device step {step_ms:.3f} ms/step "
        f"({STREAMS * 1e3 / step_ms:.1f} frames/s); process_batch {e2e_ms:.3f} ms/step "
        f"({STREAMS * 1e3 / e2e_ms:.1f} frames/s)")

    # Where the device time goes (torch.profiler over a short window).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            det.step(pk, nk, no_reset)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (OUT_DIR / "serving_profile.txt").write_text(table)
    log("profile (top rows; full table in chiprun_out/serving_profile.txt):")
    for line in table.splitlines()[:16]:
        log("  " + line)
    return dict(counts=counts, counts_fusion_off=counts_nf, step_ms=step_ms, e2e_ms=e2e_ms,
                frames_per_s=STREAMS * 1e3 / step_ms)


def phase_cpu_parity(torch, np):
    from sast_tpu_torch.config import get_config
    from sast_tpu_torch.data.representations import stacked_histogram
    from sast_tpu_torch.models.detector import build_detector
    from sast_tpu_torch.models.head import inference_outputs
    from sast_tpu_torch.packing import pack_event_batch
    from sast_tpu_torch.serving import StreamingDetector
    from sast_tpu_torch.utils.padding import InputPadder

    cfg = get_config("gen4", "base")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    h, w = cfg.dataset.resolution_hw
    rng = np.random.RandomState(11)
    frames = [synthetic_events(rng, 100_000, h, w, f) for f in range(2)]
    model_cpu = build_detector(cfg.model, seed=3, device="cpu")
    # At random init every score sits at the prior (1e-4) within about
    # 0.3%, closer together than the card and the CPU can agree on, so the
    # order of candidates would be noise. Spread the prediction logits (a
    # stand-in for trained weights) so that the comparison means something.
    with torch.no_grad():
        for k in range(len(model_cpu.head.strides)):
            for name, gain in (("cls_pred", 1000.0), ("obj_pred", 1000.0), ("reg_pred", 100.0)):
                conv = getattr(model_cpu.head, f"{name}{k}")
                conv.kernel.mul_(gain)
                conv.bias.zero_()
    model_gpu = copy.deepcopy(model_cpu).to(DEVICE)

    # A confidence threshold in the widest score gap around rank 100 of the
    # first frame, so that about 100 candidates reach NMS and no score sits
    # near the threshold.
    packed, n = pack_event_batch([frames[0]], 1, 100_000)
    with torch.no_grad():
        rep = stacked_histogram(torch.from_numpy(packed), torch.from_numpy(n), 10, h, w, 10)
        ev = InputPadder(cfg.model.backbone.in_res_hw).pad_tensor_ev_repr(rep)
        feats, _, _ = model_cpu.forward_backbone(ev)
        preds = inference_outputs(model_cpu.forward_detect(feats)["preds"])[0]
    s = (preds[:, 4] * preds[:, 5:].max(dim=-1).values).sort(descending=True).values
    gaps = s[80:120] / s[81:121]
    r = 80 + int(gaps.argmax())
    thr = float((s[r] * s[r + 1]).sqrt())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, postprocess=dataclasses.replace(cfg.model.postprocess, confidence_threshold=thr)))
    log(f"cpu parity: confidence threshold {thr:.6e} between ranks {r + 1} and {r + 2} "
        f"(relative gap {float(gaps.max()):.6f})")

    det_cpu = StreamingDetector(cfg, model_cpu, max_events=100_000, device="cpu")
    det_gpu = StreamingDetector(cfg, model_gpu, max_events=100_000, device=DEVICE)
    worst_box, worst_score = 0.0, 0.0
    for f, fr in enumerate(frames):
        oc = det_cpu.process_events(**fr)
        og = det_gpu.process_events(**fr)
        nc, ng = int(oc["valid"].sum()), int(og["valid"].sum())
        if nc != ng or nc == 0:
            fail(f"cpu parity frame {f}: {ng} detections on the card, {nc} on the CPU")
        bc, bg = oc["boxes"][oc["valid"]], og["boxes"][og["valid"]]
        cc, cg = oc["classes"][oc["valid"]], og["classes"][og["valid"]]
        scc, scg = oc["scores"][oc["valid"]], og["scores"][og["valid"]]
        # Match each CPU detection to the card's nearest box of its class
        # (the two may order near-equal scores differently).
        for i in range(nc):
            same = np.flatnonzero(cg == cc[i])
            if same.size == 0:
                fail(f"cpu parity frame {f}: class {cc[i]} missing on the card")
            d = np.abs(bg[same] - bc[i]).max(axis=1)
            j = same[d.argmin()]
            worst_box = max(worst_box, float(d.min()))
            worst_score = max(worst_score, abs(float(scg[j] - scc[i])) / float(scc[i]))
        if sorted(cc.tolist()) != sorted(cg.tolist()):
            fail(f"cpu parity frame {f}: classes differ")
        log(f"cpu parity frame {f}: {nc} detections match; selected tokens cpu "
            f"{oc['selected_tokens'].tolist()} card {og['selected_tokens'].tolist()}")
    # fp32 on both sides; the card sums convolutions and matmuls in other
    # orders: boxes are pixels up to ~700 px, scores relative.
    if worst_box > 0.05 or worst_score > 1e-3:
        fail(f"cpu parity: box diff {worst_box} px, score rel diff {worst_score}")
    log(f"cpu parity: max box diff {worst_box:.3e} px (tol 0.05), max score rel diff "
        f"{worst_score:.3e} (tol 1e-3)")
    return dict(box_diff_px=worst_box, score_rel_diff=worst_score, threshold=thr)


def main() -> None:
    if not (ROOT / "sast_tpu_torch" / "csrc").is_dir():
        fail("sast_tpu_torch/ not found beside chip_smoke.py: run it from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from sast_tpu_torch import build

    t0 = time.perf_counter()
    logs = build.build()
    (OUT_DIR / "build_log.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc log in chiprun_out/build_log.txt)")

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, np)
    log(f"phase 2: kernels hold against their plain versions ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    serving = phase_serving(torch, np, smi)
    # Launches on the path that runs each kernel: the stem and NMS kernels
    # on the default (fused) serving path, the density kernel on the
    # fusion-off path; each counted from 0 over its own run.
    for k in kernels:
        path = "counts_fusion_off" if k["name"] == "density_ratio" else "counts"
        k["launches"] = serving[path][k["name"]]
    log(f"phase 3: serving main path ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    parity = phase_cpu_parity(torch, np)
    log(f"phase 4: card matches the CPU plain path ({time.perf_counter() - t0:.1f} s)")

    record = dict(card=smi, kernels=kernels, serving=serving, cpu_parity=parity,
                  seconds=time.perf_counter() - t_start)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
