"""On the card, at a cell's own size: the program reads 0 on every number
that decides `correct`, and the control (the plain reference without its
text verification, put in the program's place) fails one of them, on
three seeds. Run on the card from the repository's root:

    python -m pytest perfbench/tests/test_pb_card.py -m card -s
"""

import json

import pytest

from perfbench import control
from perfbench.tests.conftest import ROOT

SEEDS = "3000000101,3000000102,3000000103"


@pytest.mark.card
@pytest.mark.parametrize("workload", ["chr22.hifi_sv",
                                      "chr22.hifi_sv_nopool"])
def test_control_fails_and_the_program_does_not(card, workload, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "control.json")
    assert control.main(["--workload", workload, "--seeds", SEEDS,
                         "--seconds", "5", "--out", out]) == 0
    summary = json.load(open(out))["summary"]
    assert all(v == 0 for v in summary["program_max"].values())
    assert summary["control_min"]["mismatched_reads"] > 0
