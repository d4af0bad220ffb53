"""The hybrid driver (``drivers/dflop_train_hybrid.py``) at a tiny Jamba on
the CPU: a sound run is correct against ``jamba2-3b.mixed``'s own limits,
and the control and every planted fault, ``no_reset`` and ``bwd_leak`` among
them, are not.
The tiny mix keeps items short so that rows hold several segments (what
``no_reset`` and ``seg_leak`` need).  (On the card at the cell's own size:
``portbench/control.py``, PERF.md section 2.)"""
import numpy as np
import pytest

import tiny  # noqa: F401  (puts the repo on sys.path)
from portbench import control, core

DRV = core.load_module("drivers", "dflop_train_hybrid")


def _cell():
    c = core.cell(core.benchmark(), "jamba2-3b.mixed")
    c["config"] = {**c["config"], "name": "tiny", "hidden_size": 64, "intermediate_size": 128,
                   "num_attention_heads": 4, "num_key_value_heads": 1,
                   "num_hidden_layers": 2, "attn_layer_period": 2, "attn_layer_offset": 1,
                   "vocab_size": 128, "tokens_per_media_item": 4}
    c["traffic"] = {**c["traffic"], "token_budget": 96, "profile_items": 64,
                    "mixture": {"single_image": 1.0},
                    "profiles": {"single_image": {"media": [1, 1], "text": [12, 40]}}}
    return c


def _correct(rec, cell):
    ok, _ = core.judge(rec["checks"], cell["limits"])
    return ok and rec["failed"] == 0 and rec["attempted"] > 0


def test_head_mask_takes_each_later_segments_first_tokens(monkeypatch):
    monkeypatch.setattr(DRV, "HEAD_TOKENS", 3)
    seg = np.array([1, 1, 1, 2, 2, 2, 2, 3, 3, 0, 0])
    assert DRV.head_mask(seg).tolist() == [False] * 3 + [True] * 3 + [False, True, True] + \
        [False] * 2
    assert DRV.first_segment(seg).tolist() == [True] * 3 + [False] * 8


def test_a_sound_run_is_correct_and_rows_hold_several_segments():
    cell = _cell()
    rec = DRV.run(cell, 2 ** 31 + 11, 0.5, False, device="cpu")
    assert _correct(rec, cell), rec["checks"]
    segs = np.asarray(rec["window"]["steps"][0]["segment_ids"])
    assert max(len(np.unique(r[r > 0])) for r in segs.reshape(-1, segs.shape[-1])) >= 2


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_decay", "ascent",
                                   "no_reset", "bwd_leak"])
def test_a_broken_step_is_not_correct(fault):
    cell = _cell()
    rec = DRV.run(cell, 2 ** 31 + 12, 0.5, False, device="cpu", fault=fault)
    assert not _correct(rec, cell), rec["checks"]


def test_only_the_backward_twin_sees_a_leak_in_the_backward():
    """``bwd_leak``: K5's plain version without the restart words, the
    forward sound.  ``seg_leak`` (a forward) reads 0 and passes;
    ``seg_leak_grad`` fails; a sound run reads 0 on both; the fault is
    taken out again when the program closes."""
    from repro_torch.kernels import mamba_scan
    cell, sound = _cell(), mamba_scan.bwd_plain
    lim = cell["limits"]["limits"]
    ok, _, _, _ = control.program_readings(DRV, cell, 2 ** 31 + 15, "cpu")
    bad, _, _, _ = control.program_readings(DRV, cell, 2 ** 31 + 15, "cpu", "bwd_leak")
    assert mamba_scan.bwd_plain is sound
    assert ok["seg_leak"] == 0 and ok["seg_leak_grad"] == 0
    assert bad["seg_leak"] == 0
    assert bad["seg_leak_grad"] > lim["seg_leak_grad"], bad["seg_leak_grad"]


def test_the_control_is_not_correct():
    cell = _cell()
    prog, ctl = control.readings_for(cell, 2 ** 31 + 14, "cpu", control=True)
    assert core.judge(prog["numbers"], cell["limits"])[0], prog["numbers"]
    assert not core.judge(ctl["numbers"], cell["limits"])[0], ctl["numbers"]
