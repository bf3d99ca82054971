"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``src/repro/launch/serve.py``) on the CPU.

The admission KP is the port's exact cyclic-SCD ``DenseKP`` solve: on the
queues of ``tests/test_serving.py`` the picked sets and iteration counts
equal the reference's, and lam agrees to rtol 1e-5 (float reductions in
another order), warm and cold. The request queue comes from
``np.random.default_rng(seed)`` in both packages and admission does not
read the weights, so ``serve_loop``'s admitted sets, tick by tick, and its
completion order equal the reference's exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as rreg  # noqa: E402
from repro.launch import serve as R  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as T  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Smoke-size tensors gain nothing from threads, and the suite runs six
    workers on the host's cores: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _queue(mod, case):
    if case == "six":
        return [mod.Request(rid=i, prompt_len=10 * (i + 1), max_new=10) for i in range(6)], 90.0, 3
    if case == "short_long":
        return [mod.Request(rid=0, prompt_len=8, max_new=4),
                mod.Request(rid=1, prompt_len=8, max_new=100)], 20.0, 2
    return [mod.Request(rid=i, prompt_len=10 + 3 * i, max_new=8 + i) for i in range(8)], 120.0, 4


@pytest.mark.parametrize("case", ["six", "short_long", "eight"])
def test_admission_matches_reference(case):
    rq, budget, slots = _queue(R, case)
    tq, _, _ = _queue(T, case)
    cold_r = R.admission_solve(rq, kv_budget=budget, free_slots=slots)
    cold_t = T.admission_solve(tq, kv_budget=budget, free_slots=slots, device="cpu")
    warm_r = R.admission_solve(rq, kv_budget=budget, free_slots=slots, lam0=cold_r.lam)
    warm_t = T.admission_solve(tq, kv_budget=budget, free_slots=slots, lam0=cold_t.lam,
                               device="cpu")
    for r, t in ((cold_r, cold_t), (warm_r, warm_t)):
        assert t.picked == r.picked and t.iters == r.iters
        assert t.lam.shape == (1,)
        np.testing.assert_allclose(t.lam, np.asarray(r.lam), rtol=1e-5, atol=0)
    assert warm_t.picked == cold_t.picked and warm_t.iters <= cold_t.iters
    kv = {r.rid: r.prompt_len + r.max_new for r in tq}
    assert 0 < len(cold_t.picked) <= slots
    assert sum(kv[i] for i in cold_t.picked) <= budget + 1e-6


def test_admission_empty_queue_no_solve():
    assert T.admission_solve([], kv_budget=100.0, free_slots=2, device="cpu") == ([], None, 0)
    adm = T.admission_solve([T.Request(rid=0, prompt_len=8, max_new=4)], kv_budget=100.0,
                            free_slots=0, device="cpu")
    assert adm.picked == [] and adm.lam is None


@pytest.mark.parametrize("name", ["gemma-2b", "moonshot-v1-16b-a3b", "mamba2-370m",
                                  "jamba-v0.1-52b", "deepseek-v2-236b"])
def test_serve_loop_matches_reference(name):
    kw = dict(n_requests=6, cache_len=128, kv_budget=400.0, max_batch=3, max_ticks=220)
    done_r, sets_r, stats_r = R.serve_loop(rreg.get(name).smoke(), **kw)
    done_t, sets_t, stats_t = T.serve_loop(treg.get(name).smoke(), device="cpu", **kw)
    assert sets_t == sets_r
    assert [r.rid for r in done_t] == [r.rid for r in done_r]
    assert stats_t["admission_iters"] == stats_r["admission_iters"]
    assert len(done_t) == 6 and all(r.done >= r.max_new for r in done_t)
    cold = T.serve_loop(treg.get(name).smoke(), device="cpu", warm=False, **kw)
    assert cold[1] == sets_t and [r.rid for r in cold[0]] == [r.rid for r in done_t]
    assert stats_t["warm"] and not cold[2]["warm"] and len(stats_t["admission_iters"]) >= 2


def test_cli_smoke_on_cpu(capsys):
    T.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] completed 8 requests in ")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the error without one")
    cfg = treg.get("gemma-2b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        T.serve_loop(cfg, n_requests=2)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        T.main(["--arch", "gemma-2b", "--smoke"])
