"""The port's multi-GPU fit on the CPU: the (p, d) mesh over gloo.

The counterpart of tests/test_parallel.py.  Sharding is an execution
detail: the sharded SVGD step at world sizes 2, as (2, 1), and 4, as
(2, 2), must give the unsharded step's particles and moments (1e-10 at
float64) and phlash_tpu's (1e-9); so must the sharded held-out ELPD (the
aux_out of phlash_tpu's shard_training_step), a meshed fit, and a meshed
fit resumed from its checkpoint.  The comms contract of
test_parallel.py:119-163 is read from the port's collective counter.

Each world size is one spawn of its ranks, which run every case and
return numpy arrays; the parent computes the unsharded and the JAX side.
Rank 0 writes its checkpoints WRITE_DELAY seconds late, as a loaded host
may: a rank that read the file before its last write was on disk would
resume at another iteration than rank 0 and hang the world.
The ranks import this module, so JAX is imported only inside the tests.
Every process group has a 60 s timeout and every rank a join deadline, so
a dead rank fails its test instead of hanging the suite.
"""

import datetime
import multiprocessing as mp
import pickle
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from phlash_tpu_torch import mcmc, training  # noqa: E402
from phlash_tpu_torch.data import RawContig  # noqa: E402
from phlash_tpu_torch.parallel import make_mesh, mesh as comms, shard_training_step  # noqa: E402

OVERLAP, BODY, N_CHUNKS = 24, 96, 256
P = 8  # particles
INDS = np.array([[0, 200], [77, 3], [255, 255]])  # k = 3 rows of S = 2 chunk indices
AFS = np.array([50.0, 20.0, 10.0, 5.0, 2.0])
TIMEOUT = datetime.timedelta(seconds=60)
JOIN_SECONDS = 240
WRITE_DELAY = 0.5  # seconds rank 0's checkpoint writer waits before each write
NITER = 20  # iterations of the fits
FIT = dict(device="cpu", kernel_backend="smc", num_particles=P, chunk_size=BODY,
           overlap=OVERLAP, minibatch_size=2, steps_per_call=2, elpd_samples=2,
           double_precision_params=True, progress=False)


def _chunks() -> np.ndarray:
    rng = np.random.default_rng(11)
    d = rng.binomial(1, 0.05, size=(N_CHUNKS, OVERLAP + BODY)).astype(np.int8)
    d[5, 30:60] = -1
    return d


def _contigs():
    "Two training contigs and one held out, Bernoulli(0.05) hets."
    rng = np.random.default_rng(5)
    het = [(rng.random((1, n)) < 0.05).astype(np.int8) for n in (2400, 2400, 1200)]
    return [RawContig(het_matrix=h, afs=np.ones(1), window_size=100) for h in het]


def _program(mesh, afs, backend="smc"):
    """The step's program at float64 on the CPU (the kernels' plain
    versions): smc with the warm-up overlap, or packed without one (its rows
    padded to the kernel's period)."""
    overlap = OVERLAP if backend == "smc" else 0
    return training.build_training(
        _chunks()[:, OVERLAP - overlap:], afs, window_size=100, overlap=overlap,
        device=torch.device("cpu"), generator=torch.Generator().manual_seed(3),
        kernel_backend=backend, mesh=mesh,
        options=dict(num_particles=P, minibatch_size=2, niter=10, double_precision_params=True))


def _elpd(prog, backend):
    overlap = OVERLAP if backend == "smc" else 0
    return mcmc.held_out_elpd(prog, _contigs()[2], span=BODY + overlap, overlap=overlap,
                              elpd_samples=3, device="cpu", kernel_backend=backend)


def _arrays(state) -> dict:
    return {n: t.detach().numpy().copy()
            for n, t in zip(("particles", "mu", "nu", "nu_max", "count"), state.tensors())}


def _c(models) -> np.ndarray:
    return np.stack([m.eta.c.numpy() for m in models])


def _steps(mesh, afs, backend="smc") -> dict:
    """Three steps of the program from its initial cloud on INDS (with the
    collectives they ran) and the held-out ELPD after them, by a Caller."""
    prog = _program(mesh, afs, backend)
    state = prog.state
    start = state.particles if mesh is None else comms.gather_rows(mesh, state.particles, "t")
    elpd = _elpd(prog, backend)
    comms.reset_counts()
    for row in torch.as_tensor(INDS):
        state = prog.base_step(state, row)
    counts = comms.counts()
    elpd_inds = torch.tensor([4, 0, 9])
    if mesh is None:
        call = training.Caller(prog.base_step, elpd)
    else:
        place, call = shard_training_step(prog, mesh, elpd)
    called, e = call(state, torch.as_tensor(INDS[:1]), elpd_inds)
    whole = state if mesh is None else comms.gather_state(mesh, state)
    out = {"start": start.numpy().copy(), "counts": counts, "elpd": float(e),
           "elpd_particles": called.particles.numpy().copy(), **_arrays(whole)}
    if mesh is not None:  # the same ELPD from the unsharded evaluator on the whole cloud
        out["called_whole"] = comms.gather_rows(mesh, called.particles, "t").numpy().copy()
        out["placed"] = all(torch.equal(a, b) for a, b in zip(place(whole).tensors(),
                                                              state.tensors()))
    return out


def _fits(mesh, tmp: str) -> dict:
    """A fit, and the same fit interrupted at iteration 10 and resumed, under
    `mesh` (a resume evaluates the ELPD at its first call, so it stops where
    the ELPD cadence of 10 iterations falls)."""
    train, held = _contigs()[:2], _contigs()[2]
    kw = dict(FIT, mesh=mesh)
    out = {"fit": _c(mcmc.fit(train, held, niter=NITER, **kw))}
    ck = f"{tmp}/ckpt.npz"
    mcmc.fit(train, held, niter=NITER // 2, checkpoint_path=ck, save_every=4, **kw)
    out["resumed"] = _c(mcmc.fit(train, held, niter=NITER, checkpoint_path=ck, save_every=4,
                                 **kw))
    try:
        mcmc.fit(train, held, niter=2, **dict(kw, num_particles=P - 1))
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


def _shapes(world: int) -> dict:
    "make_mesh's shapes at this world size, and what it refuses."
    out = {"default": tuple(make_mesh(device_type="cpu").mesh.shape)}
    if world == 4:
        out["p4"] = tuple(make_mesh(4, particle_axis=4, device_type="cpu").mesh.shape)
        out["slices2"] = tuple(make_mesh(4, particle_axis=2, n_slices=2,
                                         device_type="cpu").mesh.shape)
    refused = []
    for kw in (dict(n_devices=world + 1), dict(particle_axis=3), dict(n_slices=3)):
        try:
            make_mesh(device_type="cpu", **kw)
        except ValueError:
            refused.append(sorted(kw))
    out["refused"] = refused
    return out


def _slow_writes() -> None:
    "Delay every checkpoint write of this process by WRITE_DELAY seconds."
    from phlash_tpu_torch import checkpoint

    save = checkpoint.save_checkpoint

    def slow(*args, **kw):
        time.sleep(WRITE_DELAY)
        return save(*args, **kw)

    checkpoint.save_checkpoint = slow


def _rank_main(rank: int, world: int, store: str, tmp: str, out: str) -> None:
    "One rank: every case under a (2, world // 2) mesh over gloo, pickled to `out`.rank."
    torch.set_num_threads(1)
    _slow_writes()
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=TIMEOUT)
        n_slices = 2 if world == 4 else 1
        mesh = make_mesh(world, particle_axis=2, n_slices=n_slices, device_type="cpu")
        res = {"coord": tuple(mesh.get_coordinate()),
               "afs": _steps(mesh, AFS), "no_afs": _steps(mesh, None),
               "packed": _steps(mesh, AFS, "packed"),
               "shapes": _shapes(world), **_fits(mesh, tmp)}
        dist.destroy_process_group()
    except Exception:  # reported by the parent, which fails the test with it
        res = {"error": traceback.format_exc()}
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    "[result of each rank] of one spawn of `world` ranks."
    world = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{world}")
    (tmp / "ckpt").mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, str(tmp / "store"), str(tmp / "ckpt"), str(tmp / "res")))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_SECONDS
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    assert not hung, f"ranks {hung} of {world} did not finish in {JOIN_SECONDS} s"
    results = []
    for r in range(world):
        with open(tmp / f"res.{r}", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r} of {world} failed:\n{res['error']}"
        results.append(res)
    return results


@pytest.fixture(scope="module")
def unsharded():
    "The unsharded steps (with and without the AFS term) and fit, in this process."
    train, held = _contigs()[:2], _contigs()[2]
    return {"afs": _steps(None, AFS), "no_afs": _steps(None, None),
            "packed": _steps(None, AFS, "packed"),
            "fit": _c(mcmc.fit(train, held, niter=NITER, **FIT))}


NAMES = ("particles", "mu", "nu", "nu_max")


@pytest.mark.parametrize("case", ["afs", "no_afs", "packed"])
def test_sharded_step_matches_unsharded(ranks, unsharded, case):
    """Every rank builds the unsharded initial cloud, and three sharded
    steps give the unsharded particles and moments (1e-10 at float64) and
    the same amsgrad count, on every rank: on smc with and without the AFS
    term, and on packed (no overlap, rows padded to the kernel's period)."""
    want = unsharded[case]
    for res in ranks:
        got = res[case]
        np.testing.assert_array_equal(got["start"], want["start"])
        for n in NAMES:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-10, atol=1e-12, err_msg=n)
        assert int(got["count"]) == 3


def test_sharded_step_matches_jax(ranks):
    """The sharded steps against phlash_tpu's SVGD step (optax.amsgrad, the
    dense kernel at float64) on the same particles and index rows: 1e-9."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.flatten_util import ravel_pytree

    from phlash_tpu.model import log_density_batched as jax_log_density
    from phlash_tpu.ops.kernel_dense import DenseKernel
    from phlash_tpu.params import MCMCParams as JaxMCMCParams
    from phlash_tpu.svgd import SVGD as JaxSVGD
    from phlash_tpu_torch import convert

    prog = _program(None, None)
    template = JaxMCMCParams(**convert.mcmc_fields(prog.init))
    unravel = ravel_pytree(template)[1]
    chunks = _chunks()
    kern = DenseKernel(M=16, data=chunks[:, OVERLAP:], double_precision=True)
    c = jnp.asarray([1.0, N_CHUNKS / 2, 1.0])

    def density(particles, **kw):
        return jax_log_density(particles, kern=kern, afs=None, **kw).sum()

    jsvgd = JaxSVGD(jax.grad(density), optax.amsgrad(0.1), batched_grad=True)
    jstep = jax.jit(lambda s, i, w: jsvgd.step(s, c=c, inds=i, warmup=w))
    jstate = jsvgd.init(jax.vmap(unravel)(jnp.asarray(ranks[0]["no_afs"]["start"])))
    for row in INDS:
        jstate = jstep(jstate, jnp.asarray(row), jnp.asarray(chunks[row, :OVERLAP]))
    want = np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(jstate.particles))
    for res in ranks:
        np.testing.assert_allclose(res["no_afs"]["particles"], want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["afs", "packed"])
def test_sharded_elpd_matches_unsharded(ranks, unsharded, case):
    """shard_training_step's (place, step): place keeps a rank's block of
    the whole state, and step's aux output, the held-out ELPD after one
    more step, is the same on every rank and equal to the unsharded
    evaluator's; the particles of that fourth step within 1e-10 of the
    unsharded ones (coordinates of order 1, so 1e-10 absolute where they
    cross zero)."""
    for res in ranks:
        got = res[case]
        assert got["placed"]
        np.testing.assert_allclose(got["called_whole"], unsharded[case]["elpd_particles"],
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got["elpd"], unsharded[case]["elpd"], rtol=1e-10)
    assert len({res[case]["elpd"] for res in ranks}) == 1


def test_meshed_fit_and_resume(ranks, unsharded):
    """fit(mesh=...) with held-out data and steps_per_call 2 equals the
    unsharded fit (1e-10 at float64), every rank returns the same models,
    and the fit interrupted at iteration 10 and resumed from its checkpoint
    equals the uninterrupted one."""
    for res in ranks:
        np.testing.assert_allclose(res["fit"], unsharded["fit"], rtol=1e-10)
        np.testing.assert_array_equal(res["fit"], ranks[0]["fit"])
        np.testing.assert_allclose(res["resumed"], res["fit"], rtol=1e-12)


def test_indivisible_cloud_is_refused(ranks):
    "A cloud that the particle axis does not divide raises, as JAX's sharding does; no padding."
    for res in ranks:
        assert "do not divide" in res["indivisible"]


def test_mesh_shapes(ranks):
    """make_mesh's shapes: (n, 1) below 4 devices, (n // 2, 2) from 4; an
    explicit particle axis; slices outermost on p; and the refusals: a
    device count other than the world size, axes that do not tile it, a
    slice count that does not divide p."""
    world = len(ranks)
    coords = sorted(res["coord"] for res in ranks)
    assert coords == [(i, j) for i in range(2) for j in range(world // 2)]
    shapes = ranks[0]["shapes"]
    assert shapes["default"] == ((2, 1) if world == 2 else (2, 2))
    if world == 4:
        assert shapes["p4"] == (4, 1)
        assert shapes["slices2"] == (2, 2)
        assert shapes["refused"] == [["n_devices"], ["particle_axis"], ["n_slices"]]
    else:
        assert shapes["refused"] == [["n_devices"], ["particle_axis"], ["n_slices"]]


def test_comms_contract(ranks):
    """The comms contract of tests/test_parallel.py:119-163, from the
    collective counter of three sharded steps: one row fetch and one
    density all-reduce over d and one cloud all-gather over p an
    iteration, none of them near the chunk tensor's size; with slices
    outermost on p (n_slices=2 at world size 4), what crosses the slices
    (the p axis and the whole world) is small."""
    full_bytes = N_CHUNKS * (OVERLAP + BODY)  # int8: 1 B an element
    CAP = full_bytes // 8
    DCN_CAP = 64 * 1024
    for res in ranks:
        colls = comms.collectives(res["afs"]["counts"])
        assert {k: n for k, (n, _) in colls.items()} == {
            "all_reduce/d/rows": 3, "all_reduce/d/density": 3, "all_gather/p/cloud": 3}
        offenders = {k: b for k, (_, b) in colls.items() if b > CAP}
        assert not offenders, f"collectives near the chunk tensor's {full_bytes} B: {offenders}"
        assert colls["all_reduce/d/rows"][1] == 2 * (OVERLAP + BODY)  # S rows of int8
        crossing = {k: b for k, (_, b) in colls.items() if "/d/" not in k and b > DCN_CAP}
        assert not crossing, f"large collectives across slices: {crossing}"


@pytest.fixture
def world_of_one():
    "A single-rank gloo group over a local store, as make_mesh makes it without torchrun."
    assert not dist.is_initialized()
    yield make_mesh(1, device_type="cpu", timeout=TIMEOUT)
    dist.destroy_process_group()


def test_world_of_one_fit_equals_unsharded(world_of_one, unsharded):
    """fit(mesh=make_mesh(1)) in a plain process (no torchrun): a (1, 1)
    mesh whose collectives are identities, bitwise the unsharded fit."""
    assert tuple(world_of_one.mesh.shape) == (1, 1)
    train, held = _contigs()[:2], _contigs()[2]
    got = _c(mcmc.fit(train, held, niter=NITER, mesh=world_of_one, **FIT))
    np.testing.assert_array_equal(got, unsharded["fit"])
