#!/usr/bin/env python
"""Chip smoke test: the library's main path once, on one NVIDIA GPU.

Run from the repository root::

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the four-card paths only

Phases, each printed as one JSON line; the first failure raises and the
script exits non-zero:

- ``device``: JAX must see a GPU (there is no CPU fallback); prints the
  card's name and power limit as ``nvidia-smi`` reports them.
- ``precision``: the flagship's 1788 x 16384 Gram under the library
  matmul policy against a float64 NumPy Gram (relative max error at
  most 1e-5, which TF32 cannot meet); the TF32 error is printed for
  information.
- ``kernel``: the fused weights-QP kernel (ops/pallas_qp.py) compiled
  at real widths against the plain XLA solver, objectives in float64.
- ``flagship``: best-of-100 archetypal analysis at the HadISST protocol
  (bench.py's workload) with both weights-QP backends; both winners are
  re-costed in float64 on the host.
- ``estimators``: GPNH convex coding, k-means with the gap statistic,
  PCA and kernel AA at case-study widths, each audited in float64.

The last line of standard output is ``{"ok": true, "device": {...}}``.
With ``--four-cards`` only the restart-sharded and sample-sharded fits
run, each against its one-card counterpart from the same keys.
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

#: Kernel-phase problems: (name, restarts R, rows n, width k, active m).
KERNEL_CASES = (
    ("headline_chunk", 25, 1788, 6, None),
    ("widest_sweep_k", 10, 900, 20, None),
    ("masked_bucket", 25, 1788, 8, 6),
)

#: A kernel row may end above the XLA solver's objective by at most
#: this much: the float32 resolution of O(1-10) objectives at
#: ``epsilon_two=1e-6``.
QP_OBJECTIVE_SLACK = 1e-4
ROW_SUM_TOL = 1e-5
GRAM_REL_TOL = 1e-5
AUDIT_REL_TOL = 1e-3


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def fail(msg):
    raise SystemExit("chip_smoke: " + msg)


def device_phase():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail("no GPU: JAX reports platform %r" % dev.platform)
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    import bench
    card = bench.card_line()
    print(card, flush=True)
    emit("device", card=card, **info)
    return info, card


# --------------------------------------------------------------------------
# Host-side float64 references (also exercised by the CPU test suite)
# --------------------------------------------------------------------------


def rel_err(x, ref):
    """Relative max error of ``x`` against ``ref``."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def rel_gap(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def qp_objectives(X, A, B):
    """Per-row ``1/2 x'A_r x + b'x`` in float64 for (R, n, k) batches."""
    X, A, B = (np.asarray(v, np.float64) for v in (X, A, B))
    return (0.5 * np.einsum('rij,rjk,rik->ri', X, A, X)
            + np.sum(X * B, axis=-1))


def check_qp(X_kernel, X_xla, A, B, mask=None):
    """Compare a kernel solution with the XLA solver's; raise on a
    failed tolerance, else return the measured numbers."""
    Xk = np.asarray(X_kernel, np.float64)
    worse = float(np.max(qp_objectives(Xk, A, B)
                         - qp_objectives(X_xla, A, B)))
    row_sum = float(np.max(np.abs(Xk.sum(axis=-1) - 1.0)))
    off = (np.zeros(Xk.shape[-1], bool) if mask is None
           else ~np.asarray(mask))
    masked = float(np.max(np.abs(Xk[..., off]), initial=0.0))
    if row_sum > ROW_SUM_TOL:
        fail("QP row sums off by %g" % row_sum)
    if masked != 0.0:
        fail("masked QP coordinates not zero (%g)" % masked)
    if worse > QP_OBJECTIVE_SLACK:
        fail("QP objective worse than XLA by %g" % worse)
    return {"objective_worse_max": worse, "row_sum_err": row_sum,
            "masked_abs_max": masked}


def check_stochastic(W, what):
    err = float(np.max(np.abs(np.asarray(W, np.float64).sum(axis=1)
                              - 1.0)))
    if not np.all(np.isfinite(np.asarray(W))) or err > ROW_SUM_TOL:
        fail("%s weights not row-stochastic (row-sum error %g)"
             % (what, err))
    return err


def check_audit(cost, audit, what):
    gap = rel_gap(cost, audit)
    if not np.isfinite(float(cost)) or gap > AUDIT_REL_TOL:
        fail("%s cost %r vs float64 audit %r (rel gap %g)"
             % (what, cost, audit, gap))
    return gap


def gpnh_cost_f64(X, Z, W, lambda_W):
    """GPNH objective (models/gpnh_convex_coding.gpnh_cost) in float64."""
    X, Z, W = (np.asarray(v, np.float64) for v in (X, Z, W))
    resid = X - Z @ W.T
    cost = 0.5 * np.sum(resid * resid) / X.shape[0]
    d, k = W.shape
    if lambda_W and k > 1:
        total = k * np.sum(W * W) - np.sum(np.sum(W, axis=1) ** 2)
        cost += lambda_W * 2.0 * total / (k * d * (k - 1))
    return float(cost)


def kernel_aa_cost_f64(K, Z, C, alpha):
    """Kernel-AA objective ``0.5 tr((I-ZDC) K (I-ZDC)')/n`` in float64."""
    K, Z, C, alpha = (np.asarray(v, np.float64) for v in (K, Z, C, alpha))
    M = np.eye(K.shape[0]) - Z @ (alpha[:, None] * C)
    return float(0.5 * np.sum((M @ K) * M) / K.shape[0])


def kmeans_inertia_f64(X, centers, labels):
    X, centers = (np.asarray(v, np.float64) for v in (X, centers))
    resid = X - centers[np.asarray(labels)]
    return float(np.sum(resid * resid))


def pca_variances_f64(gram, n_components):
    """Leading explained variances from the uncentred Gram of data whose
    columns are centred in float64 here."""
    n = gram.shape[0]
    H = np.eye(n) - 1.0 / n
    evals = np.linalg.eigvalsh(H @ gram @ H)[::-1][:n_components]
    return evals / (n - 1)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def precision_phase(X_host):
    from convex_dim_red_tpu.utils.precision import (
        apply_matmul_precision, get_matmul_precision)
    X64 = np.asarray(X_host, np.float64)
    K64 = X64 @ X64.T
    X = jax.device_put(X_host)
    gram = apply_matmul_precision(jax.jit(lambda x: x @ x.T))
    err = rel_err(gram(X), K64)
    with jax.default_matmul_precision("tensorfloat32"):
        err_tf32 = rel_err(jax.jit(lambda x: jnp.dot(x, x.T))(X), K64)
    emit("precision", policy=get_matmul_precision(), gram_rel_err=err,
         tolerance=GRAM_REL_TOL, tf32_gram_rel_err_info=err_tf32)
    if err > GRAM_REL_TOL:
        fail("Gram under the %r policy has relative error %g"
             % (get_matmul_precision(), err))
    return K64


def qp_problem(R, n, k, seed):
    """``A_r = M M' + I``, ``B ~ N(0, 1)``, uniform feasible starts."""
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((R, k, k))
    A = M @ M.transpose(0, 2, 1) + np.eye(k)
    B = rng.standard_normal((R, n, k))
    X0 = np.full((R, n, k), 1.0 / k)
    return A, B, X0


def memory_fields(compiled):
    mem = compiled.memory_analysis()
    return {name: getattr(mem, name, None) for name in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def kernel_phase():
    from convex_dim_red_tpu.ops.pallas_qp import MAX_K, launch_config
    from convex_dim_red_tpu.solvers.spg import quad_simplex_spg_batch_grouped

    def solver(backend):
        return jax.jit(lambda A, B, X0, mask: quad_simplex_spg_batch_grouped(
            A, B, X0, backend=backend, mask=mask))

    cases = KERNEL_CASES + (("max_k", 2, 1788, MAX_K, None),)
    for seed, (name, R, n, k, m) in enumerate(cases):
        A, B, X0 = qp_problem(R, n, k, seed)
        mask = np.arange(k) < (k if m is None else m)
        if m is not None:
            X0 = np.where(mask, X0, 0.0)
            X0 /= X0.sum(axis=-1, keepdims=True)
        args = [jnp.asarray(v, jnp.float32) for v in (A, B, X0)]
        args.append(jnp.asarray(mask))
        t0 = time.perf_counter()
        compiled = solver("pallas").lower(*args).compile()
        compile_s = time.perf_counter() - t0
        X_kernel = jax.block_until_ready(compiled(*args))
        X_xla = jax.block_until_ready(solver("xla")(*args))
        emit("kernel", case=name, R=R, n=n, k=k, active=int(mask.sum()),
             launch=launch_config(k), compile_s=compile_s,
             memory=memory_fields(compiled),
             **check_qp(X_kernel, X_xla, A, B, mask=mask))


def audit_flagship(result, X_host, what):
    """float64 re-cost, row-stochastic weights and the monotonicity
    watchdog's rule (models/archetypal_analysis._kernel_aa_core) applied
    to the winner's cost trace."""
    import bench
    audit = bench.audit_cost_f64(result, X_host)
    watchdog = max(bench.TOL, 64.0 * float(np.finfo(np.float32).eps)
                   * float(np.sum(np.asarray(X_host, np.float64) ** 2)))
    deltas = np.asarray(result['cost_deltas'], np.float64)
    max_increase = float(deltas.max()) if deltas.size else 0.0
    if max_increase > watchdog:
        fail("%s: cost rose by %g (> watchdog %g)"
             % (what, max_increase, watchdog))
    return {"cost": float(result['cost']), "audit_f64": audit,
            "audit_rel_gap": check_audit(result['cost'], audit, what),
            "row_sum_err": check_stochastic(result['weights'], what),
            "best_index": int(result['best_index']),
            "mean_outer_iters": float(np.mean(result['n_iters'])),
            "max_cost_increase": max_increase,
            "watchdog_threshold": watchdog}


def flagship_phase(X_host, card):
    import bench
    X = jax.device_put(X_host)
    dev = jax.devices()[0]
    audits = {}
    for backend in ("xla", "pallas"):
        t0 = time.perf_counter()
        jax.block_until_ready(bench.flagship_fit(X, backend)['weights'])
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = bench.flagship_fit(X, backend)
        jax.block_until_ready(result['weights'])
        warm_s = time.perf_counter() - t0
        audits[backend] = audit_flagship(result, X_host, backend)
        emit("flagship", backend=backend, card=card,
             compile_plus_first_run_s=first_s, warm_s=warm_s,
             compile_s_est=first_s - warm_s,
             peak_bytes_in_use=(dev.memory_stats() or {}).get(
                 "peak_bytes_in_use"),
             **audits[backend])
    gap = rel_gap(audits["pallas"]["audit_f64"], audits["xla"]["audit_f64"])
    emit("flagship_backends", audit_rel_gap=gap, tolerance=AUDIT_REL_TOL)
    if gap > AUDIT_REL_TOL:
        fail("pallas and xla winners differ by %g in audited cost" % gap)


def estimators_phase(X_host, K64, jra_shape=(732, 8192), n_pcs=167):
    import bench
    from convex_dim_red_tpu import (GPNHConvexCoding, KMeans, KernelAA,
                                    PCA, gap_statistic)

    # Config 4: JRA-55-scale PCA to 167 modes, then GPNH, k = 4.
    rng = np.random.RandomState(4)
    U = rng.standard_normal((jra_shape[0], 8))
    V = rng.standard_normal((8, jra_shape[1]))
    Y = U @ V + 0.3 * rng.standard_normal(jra_shape)
    Y = ((Y - Y.mean(axis=0)) / Y.std(axis=0)).astype(np.float32)
    pcs = np.asarray(PCA(n_components=n_pcs).fit_transform(Y))
    gp = GPNHConvexCoding(
        n_components=4, lambda_W=1e-3, init='random', tolerance=1e-5,
        stopping_criterion='rel_delta_f', max_iterations=300,
        random_state=0, weights_solver_kwargs={'max_iterations': 1000})
    gp.fit(pcs)
    audit = gpnh_cost_f64(pcs, gp.weights, gp.dictionary, 1e-3)
    emit("estimator", model="GPNHConvexCoding", shape=pcs.shape, k=4,
         cost=gp.cost, audit_f64=audit, n_iter=gp.n_iter,
         audit_rel_gap=check_audit(gp.cost, audit, "GPNH"),
         row_sum_err=check_stochastic(gp.weights, "GPNH"))

    # Config 2: HadISST-scale k-means, k = 4, with the gap statistic.
    X = jax.device_put(X_host)
    km = KMeans(n_clusters=4, n_init=10, random_state=0).fit(X)
    gap, sk = gap_statistic(X, km.inertia_, 4, n_trials=20,
                            random_state=0)
    audit = kmeans_inertia_f64(X_host, km.cluster_centers_, km.labels_)
    if not (np.isfinite(gap) and np.isfinite(sk)):
        fail("gap statistic not finite: %r, %r" % (gap, sk))
    emit("estimator", model="KMeans", shape=X_host.shape, k=4,
         inertia=km.inertia_, audit_f64=audit, gap=gap, gap_sk=sk,
         audit_rel_gap=check_audit(km.inertia_, audit, "KMeans"))

    # PCA of the flagship data against a float64 eigendecomposition.
    pca = PCA(n_components=10).fit(X)
    ref = pca_variances_f64(K64, 10)
    err = rel_err(pca.explained_variance_, ref)
    if err > AUDIT_REL_TOL:
        fail("PCA explained variance off by %g" % err)
    emit("estimator", model="PCA", shape=X_host.shape, n_components=10,
         explained_variance_rel_err=err)

    # Kernel AA on the flagship's linear kernel, k = 6.
    kaa = KernelAA(
        n_components=bench.K, init='random', tolerance=bench.TOL,
        stopping_criterion='rel_delta_f', max_iterations=bench.MAX_ITER,
        random_state=0,
        dictionary_solver_kwargs={
            'max_iterations': bench.DICT_MAX_ITERATIONS},
        weights_solver_kwargs={
            'max_iterations': bench.WEIGHTS_MAX_ITERATIONS})
    kaa.fit(jnp.asarray(K64, jnp.float32))
    audit = kernel_aa_cost_f64(K64, kaa.weights, kaa.dictionary, kaa.alpha)
    emit("estimator", model="KernelAA", shape=K64.shape, k=bench.K,
         cost=kaa.cost, audit_f64=audit, n_iter=kaa.n_iter,
         audit_rel_gap=check_audit(kaa.cost, audit, "KernelAA"),
         row_sum_err=check_stochastic(kaa.weights, "KernelAA"))


def device_sets(**arrays):
    return {name: sorted(d.id for d in a.sharding.device_set)
            for name, a in arrays.items()}


def restart_sharded_check(X_host, devices):
    """The flagship restart-sharded over the cards against one card."""
    import bench
    from convex_dim_red_tpu.parallel.mesh import create_mesh, replicate
    one = bench.flagship_fit(jax.device_put(X_host, devices[0]), 'auto')
    mesh = create_mesh((len(devices),), ('restarts',), devices=devices)
    X = replicate(mesh, X_host)
    t0 = time.perf_counter()
    many = bench.flagship_fit(X, 'auto', mesh=mesh)
    jax.block_until_ready(many['weights'])
    first_s = time.perf_counter() - t0
    a_one = audit_flagship(one, X_host, "one card")
    a_many = audit_flagship(many, X_host, "restart-sharded")
    gap = rel_gap(a_many["audit_f64"], a_one["audit_f64"])
    emit("restart_sharded", cards=len(devices),
         inputs=device_sets(X=X), compile_plus_first_run_s=first_s,
         one_card=a_one, sharded=a_many, audit_rel_gap=gap)
    if a_many["best_index"] != a_one["best_index"]:
        fail("restart-sharded winner %d != one-card winner %d"
             % (a_many["best_index"], a_one["best_index"]))
    if gap > AUDIT_REL_TOL:
        fail("restart-sharded audited cost off by %g" % gap)


#: One alternating step on samples sharded over the cards must match the
#: (1, 1) mesh to this relative cost difference: the float32 resolution
#: of a 1788 x 16384 residual sum taken in another order.
STEP_REL_TOL = 1e-4


def sample_sharded_check(X_host, devices, n_restarts=4):
    """``sharded_aa_train_step`` and ``sharded_aa_fit`` with samples over
    the cards against a (1, 1) mesh, from the same initial states.

    Sharding changes only the order of the float32 sums, so one step
    agrees to ``STEP_REL_TOL``.  Whole fits diverge from there, as any
    reordering does over a hundred chaotic alternating iterations, so
    the fit is held to its own float64 audit and may not end worse than
    the one-card fit by more than ``AUDIT_REL_TOL``."""
    import bench
    from convex_dim_red_tpu.parallel.mesh import create_mesh
    from convex_dim_red_tpu.parallel.sharded_aa import (
        sharded_aa_fit, sharded_aa_train_step)
    from jax.sharding import NamedSharding, PartitionSpec as P

    n, k = X_host.shape[0], bench.K
    rng = np.random.RandomState(7)
    Zs = rng.uniform(size=(n_restarts, n, k))
    Zs /= Zs.sum(axis=2, keepdims=True)
    Cs = rng.uniform(size=(n_restarts, k, n))
    Cs /= Cs.sum(axis=2, keepdims=True)
    host = {"X": X_host, "Zs": Zs.astype(np.float32),
            "Cs": Cs.astype(np.float32),
            "alphas": np.ones((n_restarts, k), np.float32)}
    specs = {"X": P('samples', None), "Zs": P('restarts', 'samples', None),
             "Cs": P('restarts', None, None), "alphas": P('restarts', None)}

    def run(mesh):
        args = {name: jax.device_put(v, NamedSharding(mesh, specs[name]))
                for name, v in host.items()}
        order = (args["X"], args["Zs"], args["Cs"], args["alphas"])
        step = jax.jit(lambda X, Zs, Cs, alphas: sharded_aa_train_step(
            mesh, X, Zs, Cs, alphas,
            dict_iterations=bench.DICT_MAX_ITERATIONS,
            weights_iterations=bench.WEIGHTS_MAX_ITERATIONS))
        step_costs = np.asarray(step(*order)[-1], np.float64)
        fit = jax.jit(lambda X, Zs, Cs, alphas: sharded_aa_fit(
            mesh, X, Zs, Cs, alphas, tolerance=bench.TOL,
            max_iterations=bench.MAX_ITER,
            stopping_criterion=bench.CRITERION,
            dictionary_solver_kwargs={
                'max_iterations': bench.DICT_MAX_ITERATIONS},
            weights_solver_kwargs={
                'max_iterations': bench.WEIGHTS_MAX_ITERATIONS}))
        t0 = time.perf_counter()
        res = fit(*order)
        jax.block_until_ready(res['weights'])
        return (step_costs, res, device_sets(**args),
                time.perf_counter() - t0)

    step_one, one, sets_one, _ = run(
        create_mesh((1, 1), devices=devices[:1]))
    step_many, many, sets_many, first_s = run(
        create_mesh((1, len(devices)), devices=devices))
    step_gap = float(np.max(np.abs(step_many - step_one) / step_one))
    audits = [bench.audit_cost_f64(r, X_host) for r in (one, many)]
    worse = (audits[1] - audits[0]) / audits[0]
    emit("sample_sharded", cards=len(devices), restarts=n_restarts,
         inputs_one_card=sets_one, inputs_sharded=sets_many,
         compile_plus_first_run_s=first_s,
         step_costs_one_card=step_one.tolist(),
         step_costs_sharded=step_many.tolist(), step_rel_gap=step_gap,
         costs_one_card=np.asarray(one['costs']).tolist(),
         costs_sharded=np.asarray(many['costs']).tolist(),
         audit_f64=audits, sharded_worse_by=worse,
         audit_rel_gap=[check_audit(r['cost'], a, "sample-sharded")
                        for r, a in zip((one, many), audits)],
         row_sum_err=check_stochastic(many['weights'], "sample-sharded"))
    if step_gap > STEP_REL_TOL:
        fail("sample-sharded step costs off by %g" % step_gap)
    if worse > AUDIT_REL_TOL:
        fail("sample-sharded fit ends worse by %g" % worse)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card paths")
    args = parser.parse_args(argv)

    from convex_dim_red_tpu.utils.cache import enable_compilation_cache
    import bench

    info, card = device_phase()
    enable_compilation_cache()
    X_host = bench.make_data(np.float32)
    if args.four_cards:
        if info["count"] < 4:
            fail("--four-cards needs 4 GPUs, found %d" % info["count"])
        devices = jax.devices()[:4]
        restart_sharded_check(X_host, devices)
        sample_sharded_check(X_host, devices)
    else:
        K64 = precision_phase(X_host)
        kernel_phase()
        flagship_phase(X_host, card)
        estimators_phase(X_host, K64)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
