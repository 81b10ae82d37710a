"""Port vs JAX: the n-worker simulator (``core/simulate.py``) and ℓ2
logistic regression (``data/logreg.py``).

- ``LogRegProblem.from_arrays`` on the JAX-made ``A``, ``b`` gives JAX's
  ``full_loss`` and ``worker_loss`` at rtol 2e-6, and a float64 evaluation
  at rtol 1e-6: the products and the means sum in another order, and XLA's
  float32 mean over the n·m rows is itself 1.1e-6 off at x = 0.
- ``SimTrainer`` against JAX's ``SimTrainer`` from the same start on the
  same data: IntSGD (Determ.) for 10 steps on the quadratic and on logreg,
  params at rtol 1e-6 (atol 1e-6 of the largest |param|: a gradient
  coordinate that cancels to near 0 over the rows keeps only its absolute
  error). Then, with the JAX side's per-step, per-worker, per-leaf encode
  seeds handed to the port through ``seeds_fn`` (JAX's ``split(state.key)``
  → ``fold_in`` of the worker index → ``_leaf_keys`` → ``seed_from_key``),
  the counter-PRNG encode
  (``use_kernels=True``) on logreg for 5 steps: IntSGD on the default dense
  int32 wire with plain SGD, and the two slice corners (SGD, IntSGD,
  packed8) and (SGD, IntDIANA, dense8) with momentum. Each worker's integer
  image is bit-equal at every compressed step, ``max_int`` and
  ``max_local_int`` equal, params as above and losses at rtol 2e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import IntDIANA as JIntDIANA, IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.core.compressor import make_compressor as jmake  # noqa: E402
from repro.core.simulate import SimTrainer as JSimTrainer  # noqa: E402
from repro.data.logreg import make_logreg as jmake_logreg  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.wire import DenseInt as JDenseInt, PackedInt as JPackedInt  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.core.simulate import SimTrainer  # noqa: E402
from repro_torch.data.logreg import LogRegProblem, make_logreg  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

N = 4


def _close(got, want, **kw):
    """rtol 1e-6, and atol 1e-6 of the largest |value| (see the module
    docstring)."""
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), **kw)


def _jax_logreg(n=N, m=32, d=50):
    return jmake_logreg(jax.random.PRNGKey(1), n_workers=n, m=m, d=d)


def _port_logreg(jprob):
    return LogRegProblem.from_arrays(np.asarray(jprob.A), np.asarray(jprob.b), lam=jprob.lam)


def test_logreg_from_jax_arrays_matches_jax_losses():
    jprob = _jax_logreg(n=6, m=40, d=30)
    prob = _port_logreg(jprob)
    assert prob.n_workers == 6 and prob.A.dtype == torch.float32
    rng = np.random.default_rng(3)
    f64 = LogRegProblem(prob.A.double(), prob.b.double(), prob.lam)
    for scale in (0.0, 0.1, 2.0):
        x = (rng.standard_normal(30) * scale).astype(np.float32)
        tx = torch.from_numpy(x)
        got = prob.full_loss(tx).item()
        np.testing.assert_allclose(got, float(jprob.full_loss(jnp.asarray(x))), rtol=2e-6)
        np.testing.assert_allclose(got, f64.full_loss(tx.double()).item(), rtol=1e-6)
        for w in range(6):
            jb = {"A": jprob.A[w], "b": jprob.b[w]}
            tb = {"A": prob.A[w], "b": prob.b[w]}
            got = prob.worker_loss({"x": tx}, tb).item()
            np.testing.assert_allclose(
                got, float(jprob.worker_loss({"x": jnp.asarray(x)}, jb)), rtol=2e-6)
            want64 = f64.worker_loss({"x": tx.double()}, {"A": f64.A[w], "b": f64.b[w]})
            np.testing.assert_allclose(got, want64.item(), rtol=1e-6)


def test_make_logreg_shapes_labels_and_heterogeneity():
    gen = torch.Generator().manual_seed(1)
    prob = make_logreg(gen, n_workers=5, m=64, d=20, device="cpu")
    assert tuple(prob.A.shape) == (5, 64, 20) and tuple(prob.b.shape) == (5, 64)
    assert set(prob.b.unique().tolist()) <= {-1.0, 1.0}
    iid = make_logreg(torch.Generator().manual_seed(1), n_workers=5, m=64, d=20,
                      heterogeneity=0.0, device="cpu")
    spread = lambda p: float(p.A.mean(1).std(0).mean())  # noqa: E731
    assert spread(prob) > 3 * spread(iid)


def _run_jax(jcomp, loss, data, x0, steps, momentum, lr):
    """JAX's SimTrainer for ``steps`` steps; per step the params after it,
    the metrics, and before each compressed step the encode seeds and every
    worker's integer image (``encode_ints`` under the worker vmap)."""
    tr = JSimTrainer(loss, N, jcomp, jsgd(momentum=momentum), jconstant(lr))
    st = tr.init({"x": jnp.asarray(x0)})
    ctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    out = {"params": [], "max_int": [], "max_local": [], "seeds": {}, "images": {}}
    for step in range(steps):
        if step > 0:
            sub = jax.random.split(st.key)[1]
            seeds = []
            for w in range(N):
                keys = jax.tree.leaves(_leaf_keys(jax.random.fold_in(sub, w), st.params))
                seeds.append([int(kops.seed_from_key(k)) for k in keys])
            out["seeds"][step] = np.array(seeds, np.int32)

            def images(cs, b, params=st.params, step=step):
                g = jax.grad(loss)(params, b)
                ints, _ = jcomp.encode_ints(cs, g, key=sub, eta=tr.lr(jnp.int32(step)), ctx=ctx)
                return ints

            ints = jcoll.vmap_workers(images, in_axes=(0, 0))(st.comp_state, data)
            out["images"][step] = np.asarray(ints["x"])
        st, m = tr.step(st, data)
        out["params"].append(np.asarray(st.params["x"]))
        out["max_int"].append(None if m is None else float(m.max_int))
        out["max_local"].append(None if m is None else float(m.max_local_int))
    return out


def _run_port(tcomp, loss, data, x0, steps, momentum, lr, seeds=None):
    tr = SimTrainer(loss, N, tcomp, sgd(momentum=momentum), constant(lr), device="cpu",
                    seeds_fn=None if seeds is None else seeds.__getitem__)
    st = tr.init({"x": torch.from_numpy(np.asarray(x0))})
    ctx = CommCtx(n_workers=N)
    out = {"params": [], "max_int": [], "max_local": [], "images": {}}
    for step in range(steps):
        if step > 0 and seeds is not None:
            grads = tr._grads(st.params, data)
            s = torch.from_numpy(seeds[step])
            out["images"][step] = np.stack([
                tcomp.encode_ints(st.comp_state, g, seeds=s, eta=tr.lr(step), ctx=ctx.at_worker(w))[0]
                ["x"].numpy() for w, g in enumerate(grads)])
        st, m = tr.step(st, data)
        assert st.step == step + 1
        out["params"].append(st.params["x"].numpy().copy())
        out["max_int"].append(None if m is None else float(m.max_int))
        out["max_local"].append(None if m is None else float(m.max_local_int))
    return out


def _quadratic():
    bs = np.random.default_rng(0).standard_normal((N, 20)).astype(np.float32)

    def jloss(params, batch):
        return 0.5 * jnp.sum((params["x"] - batch) ** 2)

    def tloss(params, batch):
        return 0.5 * torch.sum((params["x"] - batch) ** 2)

    return jloss, tloss, jnp.asarray(bs), torch.from_numpy(bs), np.zeros(20, np.float32)


@pytest.mark.parametrize("problem", ["quadratic", "logreg"])
def test_sim_trainer_determ_matches_jax_ten_steps(problem):
    if problem == "quadratic":
        jloss, tloss, jdata, tdata, x0 = _quadratic()
        lr, momentum = 0.2, 0.0
    else:
        jprob = _jax_logreg()
        prob = _port_logreg(jprob)
        jloss, tloss = jprob.worker_loss, prob.worker_loss
        jdata, tdata = jprob.worker_data(), prob.worker_data()
        x0, lr, momentum = np.zeros(50, np.float32), 0.3, 0.9
    want = _run_jax(jmake("intsgd_determ"), jloss, jdata, x0, 10, momentum, lr)
    got = _run_port(make_compressor("intsgd_determ"), tloss, tdata, x0, 10, momentum, lr)
    for step, (g, w) in enumerate(zip(got["params"], want["params"])):
        _close(g, w, err_msg=f"step {step}")
    assert got["max_int"][0] is None and got["max_int"][1:] == want["max_int"][1:]
    assert got["max_local"][1:] == want["max_local"][1:]
    assert min(got["max_int"][1:]) > 0


CORNERS = {
    # (JAX compressor, port compressor, momentum)
    "intsgd-dense32": (lambda: JIntSGD(use_kernels=True), lambda: make_compressor("intsgd"), 0.0),
    "intsgd-packed8": (lambda: JIntSGD(bits=8, wire=JPackedInt(8, use_kernels=True),
                                       use_kernels=True),
                       lambda: make_compressor("intsgd8_packed"), 0.9),
    "intdiana-dense8": (lambda: JIntDIANA(bits=8, wire=JDenseInt(8, use_kernels=True)),
                        lambda: make_compressor("intdiana", bits=8, wire="dense8"), 0.9),
}


@pytest.mark.parametrize("corner", sorted(CORNERS))
def test_sim_trainer_with_jax_seeds_matches_jax_logreg(corner):
    jc, tc, momentum = CORNERS[corner]
    jprob = _jax_logreg()
    prob = _port_logreg(jprob)
    x0 = np.zeros(50, np.float32)
    want = _run_jax(jc(), jprob.worker_loss, jprob.worker_data(), x0, 5, momentum, 0.3)
    got = _run_port(tc(), prob.worker_loss, prob.worker_data(), x0, 5, momentum, 0.3,
                    seeds=want["seeds"])
    for step in range(1, 5):
        assert got["images"][step].shape == (N, 50)
        np.testing.assert_array_equal(got["images"][step], want["images"][step],
                                      err_msg=f"step {step}")
    assert got["max_int"][1:] == want["max_int"][1:] and min(got["max_int"][1:]) > 0
    assert got["max_local"][1:] == want["max_local"][1:] and min(got["max_local"][1:]) > 0
    for step, (g, w) in enumerate(zip(got["params"], want["params"])):
        _close(g, w, err_msg=f"step {step}")
        np.testing.assert_allclose(prob.full_loss(torch.from_numpy(g)).item(),
                                   float(jprob.full_loss(jnp.asarray(w))), rtol=2e-6)


def test_sim_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the simulator runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimTrainer(lambda p, b: p["x"].sum(), N, make_compressor("intsgd"), sgd(),
                   constant(0.1))
    tr = SimTrainer(lambda p, b: p["x"].sum(), N, make_compressor("intsgd"), sgd(),
                    constant(0.1), device="cpu", seeds_fn=lambda step: np.zeros((N, 2), np.int32))
    st = tr.init({"x": torch.zeros(3)})
    st, _ = tr.step(st, torch.zeros(N, 3))
    with pytest.raises(ValueError, match="expected"):
        tr.step(st, torch.zeros(N, 3))
