"""The control, the fp8 reference put in the port's place, reads a widest
gap above the limit where the port in its bf16 serving mode reads one
below it: at a reduced size on the CPU, on three seeds, every session
ending after 48 tokens, with the limit set between this size's readings
over seeds 11-20 (bf16: 0.063-0.212; fp8: 0.468-1.184)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

import pytest  # noqa: E402

LIMIT = 0.34


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_where_the_port_passes(tmp_path, seed):
    root = tinycell.make_copy(tmp_path, limit=LIMIT)
    with tinycell.bf16_compute():
        out = tinycell.run(root, "tiny-fixed", seed=seed, seconds=30.0,
                           control=True)
    assert out["correct"], out["compared"]
    assert out["control"]["widest_gap"] > LIMIT
