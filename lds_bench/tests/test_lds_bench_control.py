"""The control: the reference computed through float8 products fails the
cell's limit, at small widths on the CPU (a quarter of the UNet's, the
vocoder's whole geometry), on three seeds; the program passes it, in
float32 and in the served bf16.  (At the cells' own sizes on the chip:
`python3 -m lds_bench.calibrate --workload <cell> --seeds ... --control`.)"""

import pytest
import torch

from lds_bench import calibrate, manifest
from lds_bench.tests import tiny


@pytest.mark.parametrize("name,traffic", [("flagship", "solo"), ("general", "b32")])
def test_control_fails_the_limit(name, traffic):
    limit = manifest.config(name)["limits"]["wav_rel_err"]
    t = tiny.traffic(traffic)
    t["check_calls"] = 2
    rows = calibrate.readings(tiny.config(name, size="small"), t, [1, 2, 2**31 + 3], True, torch.device("cpu"))
    assert all(r["control"] > limit for r in rows)
    assert all(r["program"] < limit / 100 for r in rows)
    rows = calibrate.readings(tiny.config(name, "bfloat16", size="small"), t, [1], False, torch.device("cpu"))
    assert rows[0]["program"] < limit


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct(card):
    from lds_bench.run import main

    assert main(["--workload", "flagship.solo", "--seed", "123456789", "--seconds", "2", "--trace", "0"]) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
