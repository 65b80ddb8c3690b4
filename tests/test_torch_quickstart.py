"""The port's quickstart (``launch/quickstart.py``, the reference's
``examples/quickstart.py``) on the CPU at a small size: the loss falls,
the checkpoint round-trips bit for bit, and two greedy requests come back
with 12 tokens each.  Without ``--device`` it runs on the card, so on a
machine without one it raises instead of falling back to the CPU."""

import pytest
import torch

from repro_torch.launch import quickstart
from repro_torch.training.checkpoint import same_bits

ARGV = ["--device", "cpu", "--steps", "30", "--batch", "2", "--seq", "32"]


@pytest.fixture(scope="module")
def run():
    return quickstart.main(ARGV)


def test_loss_falls(run):
    losses = run["losses"]
    assert sorted(losses) == [0, 20, 29]
    assert losses[29] < losses[0]


def test_checkpoint_round_trips_bit_for_bit(run):
    # main raises if any leaf differs; it reports the leaves it compared
    assert run["checkpoint_leaves"] > 0


def test_two_requests_of_twelve_tokens(run):
    from repro_torch.configs import get_smoke_config
    vocab = get_smoke_config(quickstart.ARCH).vocab
    assert len(run["generated"]) == 2
    for tokens in run["generated"]:
        assert len(tokens) == 12 and all(0 <= t < vocab for t in tokens)


def test_prints_the_reference_quickstart_lines(capsys):
    quickstart.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                     "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch: qwen3-0.6b (reduced: 2L d=")
    assert [line.split()[:2] for line in out[1:3]] == [["step", "0"],
                                                        ["step", "1"]]
    assert out[3].startswith("checkpoint round-trip OK")
    assert out[4].startswith("request 0: generated [")
    assert out[5].startswith("request 1: generated [")


def test_same_bits_tells_bytes_apart():
    a = torch.tensor([0.0, 1.5], dtype=torch.bfloat16)
    assert same_bits(a, a.clone())
    assert not same_bits(a, torch.tensor([-0.0, 1.5], dtype=torch.bfloat16))
    assert not same_bits(a, a.float())
    assert not same_bits(a, a.reshape(2, 1))


def test_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        quickstart.main(["--steps", "1"])
