"""The serve CLI's ``--tp`` and ``--mesh`` on the CPU: ``--tp 2`` runs
end to end through two spawned gloo ranks and gives ``--tp 1``'s tokens
(rank 0 prints them); ``--mesh`` runs the sharded path at tp 1 in this
process; the refusals exit non-zero with their messages (JAX's for
``--disagg`` and the static loop, the port's for ``--http`` under tp > 1
and a TwELL tile split between ranks)."""
import pytest

from repro_torch.launch import serve

BASE = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
        "--gen", "6", "--block-size", "4", "--prefill-chunk", "8"]


def _tokens(outs):
    return [o.token_ids for o in outs]


def test_tp2_prints_tp1_tokens(capfd):
    """The dense FFN with dense drafts: a path that packs or skips TwELL
    tiles would refuse the default reduced config's one tile (the last
    refusal below)."""
    argv = BASE + ["--backend", "dense", "--spec-k", "2",
                   "--draft-backend", "dense"]
    ref = _tokens(serve.main(argv + ["--tp", "1"]))
    got = _tokens(serve.main(argv + ["--tp", "2"]))
    out = capfd.readouterr().out
    assert got == ref
    assert "tensor-parallel mesh: tp=2 (gloo" in out
    assert out.count("static-loop agreement: 100.00%") == 2


def test_mesh_at_tp1_runs(capfd):
    ref = _tokens(serve.main(BASE))
    got = _tokens(serve.main(BASE + ["--mesh"]))
    assert got == ref
    assert "tensor-parallel mesh: tp=1 (gloo" in capfd.readouterr().out


@pytest.mark.parametrize("extra, message", [
    (["--disagg"], "--disagg requires unsharded KV pools"),
    (["--http", "--port", "0"], "--http under --tp > 1"),
    ([], "holds 1 TwELL tile"),
    (["--static"], "require the continuous-batching engine"),
    (["--arch", "mixtral-8x22b"], "require the continuous-batching engine"),
])
def test_tp_refusals(extra, message):
    with pytest.raises(SystemExit) as e:
        serve.main(BASE + ["--tp", "2"] + extra)
    assert message in str(e.value.code)
