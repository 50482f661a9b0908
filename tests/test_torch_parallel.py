"""Data parallelism of the port (``sast_tpu_torch/parallel/mesh.py``) on the
CPU: two ``gloo`` ranks, spawned on a free localhost port, against one
process on the same global batch.

The JAX counterpart is a mesh equivalence too (``tests/test_multichip.py``:
a sharded step equals the unsharded one), so the port is held against its
own single process here; that process is held against JAX by
``tests/test_torch_training.py``. Two ``Trainer.fit`` steps of world 2, each
rank on half the lanes, against one process on all the lanes, with every
stochastic rate at 0 (sparse-kernel path) and at 0.1 (the masked path the
regularizers fall back to). Each test has its own time limit; each rank
computes on one thread.

How close is close. In fp32 a world of two sums in another order than one
process: each rank's convolutions and products run at half the batch,
which changes how their library blocks the sums, and the ranks' partial
sums are added last. AdamW then turns a coordinate's rounding noise into a
step of the learning rate wherever the exact gradient is zero or below that
noise (the key projection's bias, whose gradient the softmax cancels, and a
few others), so element by element no two such runs agree to rtol 1e-4 +
atol 1e-6 everywhere. The floor is measured on the one process computing
the same function in other orders: its convolutions without oneDNN and,
with every rate at 0, its lanes in three other orders (a permutation would
move the dropout masks with the rows). For each group of tensors (each
step's summed gradients, each parameter's change over the run, BatchNorm
statistics, EMA copy, AdamW moments) the world may leave at most 4 times as
many elements outside rtol 1e-4 + atol 1e-6 as the worst floor run does,
and its worst error may be at most 4 times the floor's. The learning rate is
constant (no warm-up), so each step moves every parameter by about the
rate, 10 times the atol: a world that applied half the update leaves most
elements outside, and the test shows that the check would catch it.
"""

import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.data.synthetic import synthetic_train_batch
from sast_tpu_torch.parallel import mesh as dp
from sast_tpu_torch.training.loop import Trainer

torch.set_num_threads(1)

WORLD = 2
LANES = 4  # the global batch
STEPS = 2
LR = 1e-5  # constant: every step moves a parameter by about this much
RTOL, ATOL = 1e-4, 1e-6
FLOOR_ORDERS = ([2, 3, 0, 1], [1, 0, 3, 2], [3, 2, 1, 0])  # lane orders of the floor
FLOOR_FACTOR = 4
LIMIT_S = 120  # per spawned world


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, port, out_dir, args):
    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, WORLD, is_master=rank == 0)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        result = fn(dp.make_mesh("cpu"), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        dist.destroy_process_group()
        raise
    leave_together(store)


def leave_together(store) -> None:
    """Tear a world down so that no rank leaves while another is still in
    it: a barrier, so that no collective is in flight when a rank closes its
    connections; then each rank destroys its process group and counts
    itself out on the store, and rank 0, whose process serves the store,
    keeps it until every rank has counted itself out."""
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    store.add("left", 1)
    while rank == 0 and store.add("left", 0) < WORLD:
        time.sleep(0.01)


def _spawn(fn, tmp_path, *args):
    """Run ``fn(mesh, *args)`` on two gloo ranks; their results, in rank
    order. Fails (and ends the ranks) after ``LIMIT_S`` seconds."""
    ctx = mp.start_processes(_rank_entry, args=(fn, _free_port(), str(tmp_path), args),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + LIMIT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the world of {WORLD} did not finish in {LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _cfg(rate=0.0):
    cfg = get_test_config()
    bb = cfg.model.backbone
    bb = dataclasses.replace(
        bb, attention=dataclasses.replace(bb.attention, ls_init_value=0.3, drop_path=rate,
                                          drop_mlp=rate),
        lstm=dataclasses.replace(bb.lstm, drop_cell_update=rate))
    tr = dataclasses.replace(cfg.training, batch_size_train=LANES, ema_decay=0.9,
                             weight_decay=0.01, learning_rate=LR, seed=0,
                             lr_scheduler=dataclasses.replace(cfg.training.lr_scheduler,
                                                              use=False))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb),
                               training=tr)


def _lanes(batch, rank, world):
    """Rank ``rank``'s rows of a global batch (``ev_repr`` is (T, B, ...))."""
    n = batch["ev_repr"].shape[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    return {k: (v[:, rows] if k == "ev_repr" else v[rows]) for k, v in batch.items()}


def _global_batches(cfg, order=None):
    """The global batches; ``order`` permutes their lanes."""
    rng = np.random.RandomState(0)
    out = [synthetic_train_batch(cfg, rng) for _ in range(STEPS)]
    out[1]["is_first"] = np.array([False, True, False, True])
    if order is not None:
        out = [{k: (v[:, order] if k == "ev_repr" else v[order]) for k, v in b.items()}
               for b in out]
    return out


def _fit(mesh, rate, workdir, order=None, onednn=True):
    """Two ``fit`` steps; the compared tensors by group, the metrics, what
    the run directory holds. ``onednn=False`` computes the convolutions
    without oneDNN (PyTorch's own kernels: the same function, summed in
    another order)."""
    with torch.backends.mkldnn.flags(enabled=onednn):
        return _fit_steps(mesh, rate, workdir, order)


def _fit_steps(mesh, rate, workdir, order):
    cfg = _cfg(rate)
    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    trainer = Trainer(cfg, os.path.join(workdir, f"run{rank}"), log_every=1,
                      sparse_kernel_train=True, device="cpu", mesh=mesh)
    params = trainer.state.optimizer.params
    init = [p.detach().clone() for p in params]
    metrics, grads = [], []
    step, update = trainer.train_step, trainer.state.optimizer.step

    def recorded_step(state, batch, lstm):
        out = step(state, batch, lstm)
        metrics.append({k: float(v) for k, v in out[2].items()})
        return out

    def recorded_update():
        grads.append([p.grad.clone() for p in params])
        return update()

    trainer.train_step, trainer.state.optimizer.step = recorded_step, recorded_update
    trainer.fit([_lanes(b, rank, world) for b in _global_batches(cfg, order)], max_steps=STEPS)
    adam = trainer.state.optimizer.adamw.state
    groups = {f"step {s + 1} gradients": grads[s] for s in range(STEPS)}
    groups.update({
        "parameter changes": [p.detach() - p0 for p, p0 in zip(params, init)],
        "BatchNorm statistics": [b.clone() for b in trainer.model.buffers()],
        "EMA copy": [t.clone() for t in trainer.state.ema_params.values()],
        "AdamW moments": [adam[p][k].clone() for p in params for k in ("exp_avg", "exp_avg_sq")],
    })
    return {"groups": groups, "metrics": metrics,
            "files": sorted(os.listdir(os.path.join(workdir, f"run{rank}")))}


def _outside(got, want):
    """(elements outside rtol 1e-4 + atol 1e-6, worst absolute error)."""
    n = sum(int(((a - b).abs() > ATOL + RTOL * b.abs()).sum()) for a, b in zip(got, want))
    return n, max(float((a - b).abs().max()) for a, b in zip(got, want))


def _within_floor(got, want, floors):
    """``got`` against ``want`` beside the floor runs' tensors of the same
    group: (holds, readings)."""
    n, worst = _outside(got, want)
    floor = [_outside(f, want) for f in floors]
    n_floor, worst_floor = max(c for c, _ in floor), max(w for _, w in floor)
    holds = n <= FLOOR_FACTOR * n_floor and (n == 0 or worst <= FLOOR_FACTOR * worst_floor)
    return holds, dict(outside=n, worst=worst, floor_outside=[c for c, _ in floor],
                       floor_worst=worst_floor, elements=sum(t.numel() for t in want))


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rates0", "rates0.1"])
def test_world_of_two_trains_as_one_process(rate, tmp_path):
    """Two ranks on two lanes each against one process on the four:

    - every rank holds the same bits;
    - each step's summed gradients, each parameter's change, the BatchNorm
      statistics, the EMA copy and the AdamW moments agree element by
      element within rtol 1e-4 + atol 1e-6 but for at most 4 times as many
      elements as the floor runs leave outside, by at most 4 times their
      worst error (the module's docstring says why); the losses, ``num_fg``
      and ``P`` within 1e-5;
    - half the update would not pass: the check can fail."""
    ranks = _spawn(_fit, tmp_path, rate, str(tmp_path))
    ref = _fit(None, rate, str(tmp_path / "one"))
    for g, tensors in ranks[0]["groups"].items():
        for a, b in zip(tensors, ranks[1]["groups"][g]):
            assert torch.equal(a, b), g  # the ranks' states stay identical
    floors = [_fit(None, rate, str(tmp_path / "floor"), onednn=False)]
    if rate == 0.0:
        floors += [_fit(None, rate, str(tmp_path / "floor"), order=np.array(o))
                   for o in FLOOR_ORDERS]
    for g, want in ref["groups"].items():
        holds, readings = _within_floor(ranks[0]["groups"][g], want,
                                        [f["groups"][g] for f in floors])
        print(f"rate {rate}, {g}: world 2 {readings}")
        assert holds, (g, readings)
    # The check can fail: half of one process's update is outside nearly
    # everywhere.
    change = ref["groups"]["parameter changes"]
    holds, readings = _within_floor([c / 2 for c in change], change,
                                    [f["groups"]["parameter changes"] for f in floors])
    assert not holds and readings["outside"] > readings["elements"] // 2, readings
    print(f"rate {rate}: parameter change up to {max(float(c.abs().max()) for c in change):.3g}")
    for s, (a, b) in enumerate(zip(ranks[0]["metrics"], ref["metrics"])):
        assert set(a) == set(b)
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg", "P"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
        # The norm of the summed gradients: within 1e-5 at step 1; from
        # step 2 on, taken at parameters that AdamW moved by the rounding
        # noise of step 1, within 1e-5 or 4 times what the floor runs move it.
        floor = max(abs(f["metrics"][s]["grad_norm"] - b["grad_norm"]) for f in floors)
        print(f"rate {rate}, step {s + 1}: grad_norm {a['grad_norm']} against {b['grad_norm']}, "
              f"floor runs within {floor:.3g}")
        tol = 1e-5 * abs(b["grad_norm"]) if s == 0 else max(1e-5 * abs(b["grad_norm"]),
                                                          FLOOR_FACTOR * floor)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= tol
    # Only rank 0 logs and saves.
    assert {"ckpts", "metrics.jsonl"} <= set(ranks[0]["files"]) and ranks[1]["files"] == []


def _batch_norm(mesh, x_all, g_all):
    from sast_tpu_torch.models.layers import BatchNorm

    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    n = x_all.shape[0] // world
    x = x_all[rank * n:(rank + 1) * n].clone().requires_grad_(True)
    bn = BatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[-1]))
    bn.use_batch_stats, bn.mesh = True, mesh
    y = bn(x)
    (y * g_all[rank * n:(rank + 1) * n]).sum().backward()
    grads = [bn.scale.grad, bn.bias.grad]
    if mesh is not None:
        for g in grads:
            dist.all_reduce(g)
    return {"y": y.detach(), "dx": x.grad, "dscale": grads[0], "dbias": grads[1],
            "mean": bn.mean, "var": bn.var}


def test_batch_norm_over_two_ranks_is_the_global_batch(tmp_path):
    """Forward (output, running statistics) and backward (input and
    parameter gradients, the latter summed over the ranks) of two ranks
    equal one process on the concatenated batch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 7, 8, generator=g) * 3 + 1
    up = torch.randn(6, 5, 7, 8, generator=g)
    ranks = _spawn(_batch_norm, tmp_path, x, up)
    ref = _batch_norm(None, x, up)
    for k in ("dscale", "dbias", "mean", "var"):
        for r in ranks:
            torch.testing.assert_close(r[k], ref[k], rtol=1e-5, atol=1e-6, msg=k)
    for k in ("y", "dx"):
        got = torch.cat([r[k] for r in ranks])
        torch.testing.assert_close(got, ref[k], rtol=1e-5, atol=1e-6, msg=k)


def _eval_clips(cfg, lane):
    """Two clips of one evaluation lane, made in memory at the model's
    resolution, two labeled timesteps each, past the evaluator's first
    0.5 s."""
    from sast_tpu_torch.data.labels import FrameLabels
    from sast_tpu_torch.data.synthetic import sparse_event_input

    rng = np.random.RandomState(10 + lane)
    T, (h, w) = cfg.dataset.sequence_length, cfg.model.backbone.in_res_hw
    clips = []
    for c in range(2):
        labels = [None] * T
        for t in (1, T - 1):
            n = rng.randint(1, 4)
            bw, bh = rng.uniform(8, 30, n), rng.uniform(8, 24, n)
            rows = np.stack([np.full(n, (20 + 100 * lane + c * T + t) * 50_000),
                             rng.uniform(0, w - bw),
                             rng.uniform(0, h - bh), bw, bh,
                             rng.randint(0, cfg.model.head.num_classes, n), np.ones(n)], 1)
            labels[t] = FrameLabels(rows, (h, w))
        clips.append({"ev_repr": sparse_event_input(rng, (T, h, w, 20), 0.9),
                      "labels": labels, "is_first": c == 0,
                      "is_real_mask": np.ones((T,), bool)})
    return clips


def _with_ground_truth(eval_step):
    """``eval_step`` whose detections are each frame's ground truth, moved
    and scored as functions of the box alone, and nothing else: the metrics
    then depend on which frames are evaluated, not on the batch they came
    in (random weights alone score an AP of 0)."""

    def step(batch, lstm):
        lstm, dets = eval_step(batch, lstm)
        G = batch["gt_boxes"].shape[2]
        gt = batch["gt_boxes"].reshape(-1, G, 4).float()
        dets["boxes"][:, :G] = (torch.cat([gt[..., :2] - gt[..., 2:] / 2, gt[..., :2]
                                           + gt[..., 2:] / 2], -1) + 2 * torch.sin(7 * gt)
                                ).to(dets["boxes"].dtype)
        dets["classes"][:, :G] = batch["gt_classes"].reshape(-1, G).to(dets["classes"].dtype)
        dets["cls_conf"][:, :G] = (0.5 + 0.4 * torch.cos(3 * gt[..., 0] + gt[..., 1])).to(
            dets["cls_conf"].dtype)
        dets["valid"][:, :G] = batch["gt_valid"].reshape(-1, G)
        dets["valid"][:, G:] = False
        return lstm, dets

    return step


def _validate(mesh, workdir):
    from sast_tpu_torch.data.batch import assemble_batch

    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    cfg = _cfg()
    trainer = Trainer(cfg, os.path.join(workdir, f"val{rank}"), device="cpu", mesh=mesh)
    trainer._eval_step = _with_ground_truth(trainer._eval_step)
    n = LANES // world
    lanes = [_eval_clips(cfg, lane) for lane in range(rank * n, (rank + 1) * n)]
    batches = [assemble_batch([lane[c] for lane in lanes], cfg.training.max_labeled_frames_per_lane,
                              cfg.model.head.max_gt) for c in range(2)]
    gathered = dp.allgather_host_objects({"rank": rank})
    return {"metrics": trainer.validate(batches), "gathered": gathered}


def test_allgather_and_validate_over_two_ranks(tmp_path):
    """``allgather_host_objects`` returns every rank's object in rank order
    (one process: its own); ``Trainer.validate`` over two ranks, each on
    half the lanes, gives every rank the metrics of one process over all the
    frames."""
    assert dp.allgather_host_objects({"x": 1}) == [{"x": 1}]
    ranks = _spawn(_validate, tmp_path, str(tmp_path))
    ref = _validate(None, str(tmp_path))
    assert all(r["gathered"] == [{"rank": 0}, {"rank": 1}] for r in ranks)
    assert ref["metrics"]["val/AP"] > 0.1
    for r in ranks:
        assert r["metrics"] == ref["metrics"]


@pytest.mark.parametrize("env, error", [
    ({}, None),
    ({"WORLD_SIZE": "2"}, "RANK, MASTER_ADDR, MASTER_PORT missing"),
    ({"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "127.0.0.1"}, "MASTER_PORT missing"),
], ids=["none", "world-only", "no-port"])
def test_maybe_initialize_distributed_reads_torchrun_env(env, error, monkeypatch):
    """No torchrun variable: nothing starts; some but not all: a named
    error before any rendezvous (JAX's fail-fast on a half-set env)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is None:
        assert dp.maybe_initialize_distributed("cpu") is False
        assert dp.process_shard_info() == (0, 1)
        with pytest.raises(RuntimeError, match="process group"):
            dp.make_mesh()
    else:
        with pytest.raises(RuntimeError, match=error):
            dp.maybe_initialize_distributed("cpu")
