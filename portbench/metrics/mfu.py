"""The whole step's share of the card's bf16 peak over the window: model
FLOPs of the window's real tokens (``formulas.step_model_flops``) over
(window seconds x 989 TFLOP/s).  The card's power limit is printed beside it."""
from portbench import formulas


def read(rec):
    win = rec["window"]
    if not win["steps"]:
        return None
    flops = sum(formulas.step_model_flops(rec["dims"], s["segment_ids"]) for s in win["steps"])
    return 100.0 * flops / (win["seconds"] * formulas.PEAK_BF16_FLOPS)
