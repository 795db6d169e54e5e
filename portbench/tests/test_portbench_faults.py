"""The check decides ``correct`` on the timed path's own outputs: a whole
run on the CPU (past the harness's look for a card), with the path under
test broken underneath, comes out not correct; the sound path comes out
correct, traced or not."""

import pytest
from conftest import run_cell

FAULTS = [
    ("tiny-dlrm.tiny-score", "altered"),     # an answer altered where it is produced
    ("tiny-dlrm.tiny-score", "half"),        # half of the candidates left out
    ("tiny-dcn.tiny-score", "altered"),
    ("tiny-dcn.tiny-train", "unchanged"),    # a step that returns its state unchanged
    ("tiny-dcn.tiny-train", "half"),         # half of the batch left out, the mean over the rest
    ("tiny-dlrm.tiny-train", "unchanged"),
    ("tiny-dlrm.tiny-train", "half"),
]
CELLS = ["tiny-dlrm.tiny-score", "tiny-dcn.tiny-score", "tiny-dlrm.tiny-train",
         "tiny-dcn.tiny-train"]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    result = run_cell(tiny_root, cell, fault=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_path_is_correct(tiny_root, cell, trace):
    result = run_cell(tiny_root, cell, trace=trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    if trace:
        # on the CPU only the host's readings are there: no device, no peaks
        assert all(k.split(".")[0] in ("dispatch_ms", "p99_ms") for k in result["metrics"])
    else:
        assert {"setup_s", "peak_mem_gib"} <= set(result["metrics"])
