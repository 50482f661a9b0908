"""The whole RVT serving step's share of the card's peak, in %: the model's
FLOPs per frame, counted over the RVT reference with every token attended
(``perfbench/yardstick_rvt.frame_flops``), times the window's frames per
second, over 989.4 TFLOP/s per card."""

from perfbench import yardstick, yardstick_rvt


def read(readings, cell):
    rate = readings.get("frames_per_s")
    if not rate:
        return None
    flops = yardstick_rvt.frame_flops(cell.config)
    return 100.0 * flops * rate / (yardstick.PEAK_BF16_FLOPS * cell.chips)
