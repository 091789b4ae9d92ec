"""One short run of each cell on the card, judged by its limits. Run on the
chip with ``python -m pytest --noconftest -m cuda portbench/tests``."""

import json

import pytest

from _helpers import bench

import run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell, capsys):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 17), "--seconds", "3",
                   "--trace", "0"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
