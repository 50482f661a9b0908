"""The serving upload: events packed field by field with no padding
(``packing.pack_event_fields``), only the filled prefix of each field
copied to the step's static inputs (``graphs.Staging``), and unpacked into
``pack_event_batch``'s (S, E, 4) at the head of the step
(``graphs.unpack_events``), on the CPU.

At the tests/test_torch_serving.py geometry (gen1 events at 240x304, model
resolution 256x320, partition (4, 5), tiny widths, fp32): over batches
whose lanes' counts shrink, grow, hit 0 and hit the budget, with and
without resets, the tensor the step receives is a fresh
``pack_event_batch`` bit for bit, for the live detector and a loaded
artifact; ``process_batch`` equals ``step`` fed by ``pack_event_batch``;
``serve.upload_bytes`` counts the bytes sent; ``unpack_events`` reads
the compact layout and the lanes-in-place one that ``step`` writes. The mesh case is in
tests/test_torch_serving_mesh.py, the captured step's in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from sast_tpu_torch import export
from sast_tpu_torch.config import get_test_config
from sast_tpu_torch.graphs import unpack_events
from sast_tpu_torch.models.detector import build_detector
from sast_tpu_torch.packing import pack_event_batch, pack_event_fields
from sast_tpu_torch.serving import StreamingDetector
from sast_tpu_torch.utils import timers
from tests.test_torch_serving import _serving_config

EVENTS = 1500
COUNTS = [(700, EVENTS), (EVENTS, 20), (0, 900), (300, 0), (0, 0), (1200, EVENTS)]
RESETS = [None, [True, False], [False, False], [False, True], None, [True, True]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frame(rng, n, i=0):
    """``n`` events of one 50 ms window in a camera decoder's types."""
    return dict(x=rng.randint(0, 304, n).astype(np.uint16),
                y=rng.randint(0, 240, n).astype(np.uint16),
                p=rng.randint(0, 2, n).astype(np.uint8),
                t=np.sort(rng.randint(0, 50_000, n)).astype(np.int64) + i * 50_000)


def batches(counts=COUNTS, seed=0):
    rng = np.random.RandomState(seed)
    return [[frame(rng, n, i) for n in lanes] for i, lanes in enumerate(counts)]


@pytest.fixture(scope="module")
def live():
    cfg = _serving_config(get_test_config)
    return StreamingDetector(cfg, build_detector(cfg.model, seed=0, device="cpu"),
                             max_events=EVENTS, num_streams=2, device="cpu")


def _received(module):
    """The (packed, n_events, reset) of every call of ``module``, kept."""
    seen = []
    handle = module.register_forward_pre_hook(
        lambda _, args: seen.append([a.clone() for a in args[1:4]]))
    return seen, handle


@pytest.mark.parametrize("kind", ["live", "artifact"])
def test_the_step_receives_a_fresh_pack_bit_for_bit(live, kind):
    """The (S, E, 4) events, counts and resets that the step function (the
    ``StreamingStep``, or the artifact's program) receives from
    ``process_batch`` are ``pack_event_batch``'s, bit for bit, batch after
    batch: a lane that shrinks reads zeros past its count again."""
    det = live if kind == "live" else export.ExportedStreamingDetector(
        export.export_streaming_detector(live))
    module = det.replicas[0] if kind == "live" else det._fn
    seen, handle = _received(module)
    try:
        det.reset()
        for frames, reset in zip(batches(), RESETS):
            det.process_batch(frames, reset=reset)
    finally:
        handle.remove()
    assert len(seen) == len(COUNTS)
    for i, ((packed, n, reset), frames) in enumerate(zip(seen, batches())):
        want, want_n = pack_event_batch(frames, 2, EVENTS)
        assert packed.dtype == torch.int32 and packed.is_contiguous()
        np.testing.assert_array_equal(packed.numpy(), want, err_msg=f"batch {i}")
        np.testing.assert_array_equal(n.numpy(), want_n, err_msg=f"batch {i}")
        np.testing.assert_array_equal(
            reset.numpy(), np.zeros(2, bool) if RESETS[i] is None else RESETS[i])


def test_process_batch_equals_step_on_a_fresh_pack(live):
    """``process_batch``'s slates and carried states equal those of a
    detector on the same weights stepped with ``pack_event_batch``'s
    tensors, bit for bit."""
    stepped = StreamingDetector(live.cfg, live.model, max_events=EVENTS, num_streams=2,
                                device="cpu")
    live.reset()
    for i, (frames, reset) in enumerate(zip(batches(seed=1), RESETS)):
        got = live.process_batch(frames, reset=reset)
        packed, n = pack_event_batch(frames, 2, EVENTS)
        dets, tel = stepped.step(torch.from_numpy(packed), torch.from_numpy(n),
                                 torch.tensor([False, False] if reset is None else reset))
        for k, v in dets.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=f"batch {i} {k}")
        np.testing.assert_array_equal(got["selected_tokens"], tel.numpy())
    for a, b in zip((t for hc in live.states for t in hc),
                    (t for hc in stepped.states for t in hc)):
        assert torch.equal(a, b)


def test_upload_bytes_count_the_events_counts_and_resets(live):
    """``serve.upload_bytes`` is 16 B an event of ``serve.events`` plus each
    call's lane starts and counts (int32) and resets (bool): only the filled
    events go up."""
    timers.reset()
    timers.set_spans(True)
    try:
        for frames, reset in zip(batches(seed=2), RESETS):
            live.process_batch(frames, reset=reset)
        stats = timers.timer_stats()
    finally:
        timers.set_spans(False)
        timers.reset()
    events = sum(sum(lanes) for lanes in COUNTS)
    assert stats["serve.events"]["total"] == events
    assert stats["serve.upload_bytes"]["total"] == 16 * events + len(COUNTS) * 2 * (4 + 4 + 1)
    assert live._staging.events.shape == (4, 2 * EVENTS)


def test_fields_unpack_from_compact_and_in_place_layouts():
    """``pack_event_fields`` into reused buffers, then ``unpack_events`` at
    the starts ``Staging`` uploads (the counts' exclusive cumsum), is a
    fresh ``pack_event_batch`` (the columns past the batch's events hold an
    earlier batch's, and are not read); so is ``unpack_events`` of that
    pack's fields with each lane in place (starts ``i * E``, the layout
    ``load_packed`` writes); a frame over the budget is refused."""
    S = 3
    events, n = np.full((4, S * EVENTS), -7, np.int32), np.zeros((S,), np.int32)
    counts = [(EVENTS, 5, 0), (0, EVENTS, EVENTS), (1, 0, 2), (0, 0, 0), (EVENTS,) * 3]
    for i, frames in enumerate(batches(counts, seed=3)):
        total = pack_event_fields(frames, events, n)
        want, want_n = pack_event_batch(frames, S, EVENTS)
        np.testing.assert_array_equal(n, want_n)
        assert total == want_n.sum()
        compact, in_place = (torch.zeros((4, S * EVENTS + 1), dtype=torch.int32)
                             for _ in range(2))
        compact[:, :-1] = torch.from_numpy(events)
        in_place[:, :-1] = torch.from_numpy(want).permute(2, 0, 1).reshape(4, -1)
        for lane, m in enumerate(n):  # rows past a lane's count are not read
            in_place[:, :-1].view(4, S, EVENTS)[:, lane, m:] = -7
        for card, start in ((compact, np.cumsum(n) - n), (in_place, np.arange(S) * EVENTS)):
            got = unpack_events(card, torch.from_numpy(n), torch.from_numpy(start.astype(np.int32)),
                                EVENTS)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"batch {i}")
    with pytest.raises(ValueError, match="exceed budget"):
        pack_event_fields(batches([(EVENTS + 1, 0, 0)])[0], events, n)
    with pytest.raises(ValueError, match="2 frames for 3 streams"):
        pack_event_fields(batches([(1, 1)])[0], events, n)
