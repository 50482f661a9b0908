"""The whole serving step's share of the card's peak, in %: the model's
FLOPs per frame, counted over the reference at full window density
(``perfbench/yardstick.frame_flops``), times the window's frames per second,
over 989.4 TFLOP/s per card."""

from perfbench import yardstick


def read(readings, cell):
    rate = readings.get("frames_per_s")
    if not rate:
        return None
    flops = yardstick.frame_flops(cell.config)
    return 100.0 * flops * rate / (yardstick.PEAK_BF16_FLOPS * cell.chips)
