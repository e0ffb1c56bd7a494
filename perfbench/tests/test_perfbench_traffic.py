"""The seeded traffic, the window arithmetic and the p95."""

import pytest
from conftest import ROOT

torch = pytest.importorskip("torch")

from perfbench import harness, traffic  # noqa: E402

BIG = 2 ** 31 + 12345


def mix(name):
    import json
    return json.loads((ROOT / "perfbench" / "traffic" /
                       f"{name}.json").read_text())


def test_prefill_lengths_are_log_spaced_over_the_range():
    lens = traffic.lengths(mix("prefill-grouped")["lengths"])
    assert lens == [1024, 1408, 1792, 2560, 3328, 4480, 6144, 8192]


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_same_seed_same_requests(seed):
    a = traffic.Traffic(mix("prefill-grouped"), seed, 1000)
    b = traffic.Traffic(mix("prefill-grouped"), seed, 1000)
    assert [a.prompt_len(j) for j in range(20)] == \
        [b.prompt_len(j) for j in range(20)]
    for j in (0, 5):
        assert torch.equal(a.tokens(j, "cpu"), b.tokens(j, "cpu"))
        assert a.tokens(j, "cpu").max() < 1000


def test_every_seed_offers_the_same_work_in_another_order():
    spec = mix("prefill-grouped")
    n = spec["lengths"]["count"]
    orders = []
    for seed in (1, 2, BIG):
        t = traffic.Traffic(spec, seed, 100)
        for block in range(3):
            got = [t.prompt_len(block * n + i) for i in range(n)]
            assert sorted(got) == t.lengths
        orders.append([t.prompt_len(j) for j in range(n)])
    assert len({tuple(o) for o in orders}) > 1


def test_seeds_draw_different_tokens():
    a = traffic.Traffic(mix("decode-longctx"), 1, 50000).tokens(0, "cpu")
    b = traffic.Traffic(mix("decode-longctx"), 2, 50000).tokens(0, "cpu")
    assert a.shape == (32, 4096) and not torch.equal(a, b)


def test_check_sample_holds_the_longest_batch():
    t = traffic.Traffic(mix("prefill-grouped"), 3, 100)
    done = list(range(11))
    how = {"longest_batches": 1, "other_prompts": 2}
    sample = t.check_sample(done, how)
    longest = max(done, key=t.prompt_len)
    assert [(longest, r) for r in range(4)] == sample[:4]
    assert len(sample) == 6 and len(set(sample)) == 6
    assert sample == t.check_sample(done, how)
    d = traffic.Traffic(mix("decode-longctx"), 3, 100)
    rows = d.check_sample([0], {"sessions": 4})
    assert len({r for _, r in rows}) == 4 and {b for b, _ in rows} == {0}


def test_p95_by_hand():
    assert traffic.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert traffic.p95([2.0] * 7) == 2.0


def test_window_arithmetic_of_the_readers():
    run = harness.Run(kind="prefill", window_s=2.0, tokens=8192,
                      flops=989e12, ttft_s=[0.1] * 19 + [1.1])
    read = {n: harness.metric_module(n).read(run)
            for n in ("prefill_tokens_per_s", "ttft_ms_p95", "mfu.prefill",
                      "decode_tokens_per_s")}
    assert read["prefill_tokens_per_s"] == 4096.0
    assert read["ttft_ms_p95"] == pytest.approx(150.0)
    assert read["mfu.prefill"] == pytest.approx(50.0)
    assert read["decode_tokens_per_s"] is None
    dec = harness.Run(kind="decode", window_s=4.0, tokens=64,
                      itl_s=[0.07] * 10)
    assert harness.metric_module("decode_tokens_per_s").read(dec) == 16.0
    assert harness.metric_module("itl_ms_p95").read(dec) == \
        pytest.approx(70.0)


def test_decode_window_counts_what_arrives_in_it(fixed_clock):
    from conftest import small_cell
    cell = small_cell("granite-8b.decode-longctx")
    B, G = cell.traffic["batch"], cell.traffic["gen_tokens"]
    _result, run, _checked, _p, _n = harness.run(cell, BIG, 0.5, False,
                                                 "cpu", 0.0)
    assert run.window_s == 0.5
    # the window holds later session batches, their prefills inside it
    assert run.requests >= 3 * B
    # every arrival a token of each session; a batch's first is no gap
    starts = run.tokens // B - len(run.itl_s)
    assert run.tokens % B == 0
    assert run.requests // B - 2 <= starts <= run.requests // B - 1
    assert len(run.itl_s) >= (starts - 1) * (G - 1)
    assert all(0 < g < 0.5 for g in run.itl_s)
    assert run.longest_gaps[0][0] == max(run.itl_s)
    assert all(0 < at <= 0.5 for _g, at in run.longest_gaps)
