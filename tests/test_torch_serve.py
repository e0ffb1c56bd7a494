"""Port parity, the serving launcher: ``repro_torch.launch.serve`` with
``--smoke --device cpu`` prints the reference launcher's JSON keys, with
the reference's values for the generated shape and the LCAP
cache-invalidation counts (one page evicted per replica, B - 1 left)."""

import json
import sys

import pytest

pytest.importorskip("torch")

from repro.launch import serve as ref_serve               # noqa: E402
from repro_torch.launch import serve as port_serve        # noqa: E402


def run_ref(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert ref_serve.main() == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-9b"])
def test_serve_matches_reference(monkeypatch, capsys, arch):
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len", "10",
            "--gen-len", "5", "--replicas", "3"]
    ref = run_ref(monkeypatch, capsys, argv)
    assert port_serve.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(ref)
    for key in ("arch", "generated_shape", "generated_finite",
                "evicted_per_replica", "remaining_pages"):
        assert got[key] == ref[key], key
    assert got["generated_shape"] == [3, 5]
    assert got["evicted_per_replica"] == [1, 1, 1]
    assert got["remaining_pages"] == [2, 2, 2]


def test_serve_runs_on_the_card_by_default(monkeypatch):
    """Without ``--device`` the launcher asks for the card, and refuses
    to fall back to the host when there is none."""
    monkeypatch.setattr(port_serve.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--smoke"])


def test_serve_steps_go_through_the_kernel_wrapper(monkeypatch):
    """The launcher's prefill takes the ``flash`` path: every layer calls
    the kernel's wrapper once (on the host it runs the plain version)."""
    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    calls = []
    real = fa.flash_attention_bshd

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr("repro_torch.kernels.ops.flash_attention_bshd", spy)
    cfg = C.get_smoke("gemma2-9b")
    params = T.init_params(cfg, seed=0, device="cpu")
    tokens = port_serve.make_tokens(cfg, 3, 6, device="cpu")
    out = port_serve.serve(cfg, params, tokens, gen_len=3, replicas=2)
    assert len(calls) == cfg.n_layers
    assert [c["window"] for c in calls] == [cfg.layer_window(l % 2)
                                            for l in range(cfg.n_layers)]
    assert all(c["cap"] == cfg.attn_softcap for c in calls)
    assert tuple(out["generated"].shape) == (3, 3)
    assert out["decode_steps"] == 2
    assert out["evicted_per_replica"] == [1, 1]     # object 2 of 0..2
    assert out["remaining_pages"] == [2, 2]
