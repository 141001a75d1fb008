"""The control: the reference one precision step below the configuration's
(TF32, float8 vocoder) in the program's place must fail the cell's
limits, where the program passes them.  On the card at the 44.1 kHz
widths (marked ``cuda``; the full-size readings are ``control.py``'s);
on the CPU at the tiny size, where TF32 does not exist and the float8
vocoder alone fails."""

import pytest
import torch
from conftest import BULK, ROOT, loaded_cell

import check
import control
import run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _fails(numbers, limits):
    return [k for k in check.NUMBERS if numbers[k] > limits[k]]


def test_control_fails_the_limits_on_the_cpu(tiny):
    loaded = loaded_cell(tiny, BULK, sample=8)
    numbers = control.control_numbers(loaded, 2**31 + 9, torch.device("cpu"), calls=2)
    assert _fails(numbers, loaded["check"]["limits"]) == ["pcm_err"]


@pytest.mark.cuda
def test_control_fails_where_the_program_passes_on_the_card(card):
    loaded = run.load_cell(ROOT, "v44k-bulk-longform")
    loaded["traffic"] = dict(loaded["traffic"], call_size=32)
    limits = loaded["check"]["limits"]
    assert _fails(control.control_numbers(loaded, 2**31 + 17, card, calls=1), limits)
    res = run.run_cell(loaded, 2**31 + 17, 2.0, False, "cuda")
    assert res["correct"], res["checked"]
