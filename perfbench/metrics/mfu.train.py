"""The whole training step's share of the card's peak, in %: three times
the forward FLOPs of a sequence (the backbone over its frames, the neck and
head over its labeled-frame slots; recomputation not counted;
``perfbench/yardstick.sequence_flops``), times the window's sequences per
second, over 989.4 TFLOP/s per card."""

from perfbench import yardstick


def read(readings, cell):
    rate = readings.get("seqs_per_s")
    if not rate:
        return None
    c = cell.config
    flops = 3 * yardstick.sequence_flops(c, c["sequence_length"], c["max_labeled_frames_per_lane"])
    return 100.0 * flops * rate / (yardstick.PEAK_BF16_FLOPS * cell.chips)
