"""The paper's convergence claims on the port alone, at the sizes and bounds
of ``tests/test_convergence.py``: IntSGD converges like SGD (Theorems 1-3 /
Fig. 1) on a quadratic; with momentum on heterogeneous ℓ2 logistic
regression its terminal loss is within 10 % of SGD's (Table 2's parity);
Heuristic IntSGD's fixed α (Sapio et al.) stalls short of the optimum;
the aggregate's quantization variance does not grow with n (Cor. 2); and
IntDIANA keeps the per-worker payload small where IntGD's blows up on
heterogeneous data (Appendix A.2 / Fig. 6).

Everything runs through ``SimTrainer`` on the CPU (the kernels' plain
versions), with the port's own data and encode seeds: the integers differ
from the JAX package's run (another generator), the claims do not.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import IntSGD, leaf_seeds, make_compressor  # noqa: E402
from repro_torch.core.scaling import AlphaLastStep, AlphaState  # noqa: E402
from repro_torch.core.simulate import SimTrainer  # noqa: E402
from repro_torch.data.logreg import make_logreg  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

N = 8


def _quadratic(d=20, scale=1.0):
    bs = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((N, d)) * scale).astype(np.float32))

    def loss(params, batch):
        return 0.5 * torch.sum((params["x"] - batch) ** 2)

    return loss, bs


def _final_err(comp, steps=400, lr=0.2, momentum=0.0):
    loss, bs = _quadratic()
    tr = SimTrainer(loss, N, comp, sgd(momentum=momentum), constant(lr), device="cpu")
    st = tr.init({"x": torch.zeros(20)})
    for _ in range(steps):
        st, _ = tr.step(st, bs)
    return float(torch.linalg.norm(st.params["x"] - bs.mean(0)))


@pytest.mark.parametrize("name", ["none", "intsgd", "intsgd_determ", "intsgd_block"])
def test_intsgd_matches_sgd_quadratic(name):
    """Thm 2 regime (smooth convex, deterministic gradients): every IntSGD
    variant reaches the optimum like exact SGD."""
    assert _final_err(make_compressor(name)) < 1e-5


def test_heuristic_intsgd_stalls():
    """Fig. 1: the Sapio et al. fixed-α rule fails to reach the optimum that
    adaptive IntSGD attains."""
    err_int = _final_err(make_compressor("intsgd"))
    err_heur = _final_err(make_compressor("heuristic_intsgd"))
    assert err_heur > 100 * max(err_int, 1e-12), (err_heur, err_int)


def test_intsgd_with_momentum_matches_sgd_logreg():
    """Heterogeneous logreg, momentum 0.9: terminal losses within a 10 %
    band (Table 2's accuracy parity at a constant lr)."""
    prob = make_logreg(torch.Generator().manual_seed(1), n_workers=N, m=64, d=50, device="cpu")
    data = prob.worker_data()

    def run(name):
        tr = SimTrainer(prob.worker_loss, N, make_compressor(name), sgd(momentum=0.9),
                        constant(0.3), device="cpu")
        st = tr.init({"x": torch.zeros(50)})
        for _ in range(250):
            st, _ = tr.step(st, data)
        return float(prob.full_loss(st.params["x"]))

    l_sgd, l_int = run("none"), run("intsgd")
    assert abs(l_int - l_sgd) / l_sgd < 0.10, (l_int, l_sgd)


def test_linear_speedup_variance_reduction():
    """Cor. 2's ingredient: independent per-worker rounding keeps the
    aggregate's quantization variance from growing with n (α ∝ 1/√n makes
    it about constant): within 4× over an 8× change of n."""
    g = torch.full((64,), 0.37)
    comp = IntSGD()
    gen = torch.Generator().manual_seed(0)

    def var_for(n):
        ctx = CommCtx(n_workers=n)
        state = AlphaState(r=torch.tensor(1e-4), step=torch.tensor(1, dtype=torch.int32))
        errs = []
        for _ in range(50):
            seeds = leaf_seeds(gen, n, 1, "cpu")
            ghat, _, _ = comp.aggregate(state, ({"w": g} for _ in range(n)), seeds=seeds,
                                        eta=torch.tensor(0.1), ctx=ctx)
            errs.append((ghat["w"] - g).numpy())
        return np.var(np.stack(errs))

    v2, v16 = var_for(2), var_for(16)
    assert v2 > 0 and v16 < 4 * v2 + 1e-12


def test_intdiana_bounds_max_int_heterogeneous():
    """Fig. 6 / Appendix A.2: on heterogeneous full gradients IntGD's
    per-worker payload |Int(α g_i)|∞ blows up near the optimum (||∇f_i(x*)||
    ≠ 0 while ||Δx|| → 0); IntDIANA compresses g_i − h_i with h_i → ∇f_i(x*)
    and keeps it within a few bits. Both converge."""
    loss, bs = _quadratic(d=30, scale=3.0)

    def trace(comp, steps=120, lr=0.5):
        tr = SimTrainer(loss, N, comp, sgd(), constant(lr), device="cpu")
        st = tr.init({"x": torch.zeros(30)})
        out = []
        for _ in range(steps):
            st, m = tr.step(st, bs)
            out.append(0.0 if m is None else float(m.max_local_int))
        return np.asarray(out), float(torch.linalg.norm(st.params["x"] - bs.mean(0)))

    ints_gd, err_gd = trace(IntSGD(alpha_rule=AlphaLastStep()))
    ints_diana, err_diana = trace(make_compressor("intdiana"))
    assert err_gd < 1e-4 and err_diana < 1e-4, (err_gd, err_diana)
    assert ints_gd[-1] > 1e4, ints_gd[-1]
    assert ints_diana.max() < 64, ints_diana.max()
