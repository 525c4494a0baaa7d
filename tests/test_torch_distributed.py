"""Data-parallel Neural-SDE training and serving in the port, on the CPU
(gloo ranks spawned by :func:`repro_torch.distributed.compat.launch`).

* Row-windowed one-key draws (kernel-table rows 5, 7 and 12, plain
  versions): at float32 and float64, over 2 and 3 ranks, with odd ``B·d``
  and windows that split a counter pair, the concatenated windows are the
  whole draw bitwise, and the whole draw's uniform bits are
  ``jax.random``'s.  ``BrownianPath(rows=...)`` gives the rows of the
  whole path on every query.
* The rule tables: ``param_specs`` equal ``repro.distributed.sharding.
  _spec_for`` on every leaf of each ported architecture's full-size
  parameters (meta tensors) on the production meshes, the divisibility
  fallback and ``serve_pure_tp`` included; the placements follow them.
* The collectives (two ranks): the row gather bitwise on every dtype,
  the flat mean, the broadcast, the mesh's place and row windows.
* Training, two ranks against one: two steps each of the SDE-GAN clip and
  gp steps and the ELBO step (its ΔW drawn windowed in
  ``rev_heun_phase1_gen``).  Losses and parameters agree within 1e-12 of
  the largest magnitude in float64; in float32 within ``F32_REL`` of it
  (the ranks' row means and the row-count-dependent sums round ulps apart,
  and Adadelta's first step magnifies a gradient's difference near
  ``sqrt(eps/(1−ρ))``, tests/test_torch_gan_train.py).  Every rank's
  parameters are bitwise equal after each step.
* Training, two ranks against the reference's two simulated devices (a
  subprocess with ``--xla_force_host_platform_device_count=2``): one float64
  clip step and one float64 ELBO step, weights carried across, within the
  one-device parity tests' tolerances (tests/test_torch_gan_train.py,
  tests/test_torch_training.py).
* Serving: every drain loop and a ``Scheduler(shard_base=2)`` drain over two
  ranks are bitwise the one-rank drains (the padding invariance); the
  ``--host-devices 2`` CLIs run and print the mesh line.
* Every spawn joins with a time limit: a rank that hangs is killed and the
  call fails.
"""

import functools
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dp_ranks as R
from _torch_parity import jax_config
from repro.distributed import sharding as jax_sharding
from repro_torch import tree
from repro_torch.checkpoint import params_from_jax
from repro_torch.core.brownian import BrownianPath
from repro_torch.distributed import compat, sharding
from repro_torch.kernels import ops, prng, ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.serving import synthetic_requests

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 600.0  # seconds a spawn may take before its ranks are killed
F32_REL = 2e-4  # 5x the worst seen (3.9e-5, the clip step's Adadelta update)
F64_REL = 1e-12

# ---------------------------------------------------------------------------
# row-windowed one-key draws
# ---------------------------------------------------------------------------

# (B, d): odd B·d, d odd and even, a window that splits a counter pair
WINDOW_SHAPES = [(6, 17), (5, 3), (9, 1), (4, 2)]


def _bounds(rows: int, ranks: int):
    return [rows * r // ranks for r in range(ranks + 1)]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_row_windows_concatenate_to_the_whole_draw_bitwise(dtype, shape, ranks):
    key = prng.PRNGKey(11)
    B, d = shape
    whole = ops.brownian_increment(key, 3, shape, dtype, 0.1)
    st_whole = ops.space_time_increment(key, 3, shape, dtype, 0.1)
    z = torch.randn(shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    z = z.to(dtype)
    gen_whole = ops.rev_heun_phase1_gen(z, 0.5 * z, -z, z * z, key, 3, 0.1, 0.1)
    bounds = _bounds(B, ranks)
    parts, st_parts, gen_parts = [], [], []
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        window = (r0 * d, B * d)
        parts.append(ops.brownian_increment(key, 3, (r1 - r0, d), dtype, 0.1, window=window))
        st_parts.append(ops.space_time_increment(key, 3, (r1 - r0, d), dtype, 0.1,
                                                 window=window))
        zr = z[r0:r1]
        gen_parts.append(ops.rev_heun_phase1_gen(zr, 0.5 * zr, -zr, zr * zr, key, 3, 0.1, 0.1,
                                                 window=window))
    assert torch.equal(_bits(torch.cat(parts)), _bits(whole))
    for i in range(2):
        assert torch.equal(_bits(torch.cat([p[i] for p in st_parts])), _bits(st_whole[i]))
        assert torch.equal(_bits(torch.cat([p[i] for p in gen_parts])), _bits(gen_whole[i]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_element_windows_split_counter_pairs_bitwise(dtype):
    """Windows of every start and length inside an odd draw: each is the
    slice of the whole, the pad's pair and the pairs' second lanes too."""
    k1, k2 = prng.fold_in(*prng.PRNGKey(5), 7)
    size = 23
    whole = prng.normal(k1, k2, size, dtype)
    for e0 in range(size):
        for count in (1, 2, 5, size - e0):
            if e0 + count <= size:
                got = prng.normal(k1, k2, size, dtype, (e0, count))
                assert torch.equal(_bits(got), _bits(whole[e0:e0 + count])), (e0, count)
    with pytest.raises(ValueError, match="not inside a draw"):
        prng.normal(k1, k2, size, dtype, (20, 4))


@pytest.mark.parametrize("size", [17, 34, 35])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_window_uniform_bits_equal_jax_random(dtype, size):
    """The windowed uniforms are ``jax.random.uniform``'s bits (the layout
    with ``jax_threefry_partitionable`` False), window by window."""
    with jax_config(x64=dtype == "float64"):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(21), (size,),
                                             dtype=jnp.dtype(dtype)))
    key = prng.PRNGKey(21)
    tdtype = torch.float32 if dtype == "float32" else torch.float64
    for r0, r1 in zip(_bounds(size, 3)[:-1], _bounds(size, 3)[1:]):
        got = prng.uniform(key[0], key[1], size, tdtype, (r0, r1 - r0)).numpy()
        assert np.array_equal(got.view(np.uint8), want[r0:r1].view(np.uint8))


@pytest.mark.parametrize("levy_area", [None, "space-time"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_brownian_path_rows_are_the_whole_paths_rows(dtype, levy_area):
    key = prng.PRNGKey(3)
    whole = BrownianPath(key, 0.0, 1.0, (6, 5), dtype, levy_area)
    half = BrownianPath(key, 0.0, 1.0, (6, 5), dtype, levy_area, rows=(3, 6))
    assert half.local_shape == (3, 5) and half.window == (15, 30)
    for got, want in ((half.increment(2, 8), whole.increment(2, 8)),
                      (half.value(0.37, depth=6), whole.value(0.37, depth=6)),
                      (half.evaluate(0.1, 0.6, depth=6), whole.evaluate(0.1, 0.6, depth=6))):
        for g, w in zip(*(((got,), (want,)) if levy_area is None else (got, want))):
            assert torch.equal(_bits(g), _bits(w[3:6]))
    with pytest.raises(ValueError, match="one-key path"):
        BrownianPath(key.expand(2, 2).contiguous(), 0.0, 1.0, (5,), dtype, rows=(0, 1))


SMALL_GAN = dict(hidden_dim=4, noise_dim=3, initial_noise_dim=2, width=8, disc_hidden_dim=4,
                 disc_width=8, num_steps=8, dtype=torch.float64)
SMALL_LATENT = dict(R.LATENT, dtype=torch.float64)


def _loss_of_rows(loss: str, rows):
    """``loss`` at batch 8 in float64 on the rows ``rows`` of the whole batch
    (None: the whole batch) -> the tensors to compare: per-row outputs, then
    batch means."""
    from repro_torch.core import sde
    from repro_torch.data.synthetic import air_quality_like, ou_process

    B, key = 8, prng.PRNGKey(17)
    keep = slice(None) if rows is None else slice(*rows)
    if loss in ("gan_losses", "gradient_penalty"):
        cfg = sde.NeuralSDEConfig(**SMALL_GAN)
        gen = torch.Generator().manual_seed(5)
        params = {"gen": sde.generator_init(gen, cfg), "disc": sde.discriminator_init(gen, cfg)}
        y_real = ou_process(key, B, 9, dtype=cfg.dtype)[:, keep]
        gl, dl, fake = sde.gan_losses(params, cfg, prng.fold_in_key(key, 1), y_real, B,
                                      rows=rows)
        if loss == "gan_losses":
            return [fake.detach()], [gl.detach(), dl.detach()]
        return [], [sde.gradient_penalty(params["disc"], cfg, prng.fold_in_key(key, 3),
                                         y_real, fake, B, rows).detach()]
    cfg = sde.LatentSDEConfig(**SMALL_LATENT)
    params = sde.latent_sde_init(torch.Generator().manual_seed(6), cfg)
    ys = air_quality_like(key, B, R.LATENT_SEQ, dtype=cfg.dtype)[0][:, keep]
    fn = getattr(sde, loss)
    value, parts = fn(params, cfg, prng.fold_in_key(key, 1), ys, batch=B, rows=rows)
    return [], [v.detach() for v in (value, *parts.values())]


@pytest.mark.parametrize("loss", ["gan_losses", "gradient_penalty", "latent_sde_loss",
                                  "latent_sde_loss_terminal"])
def test_losses_over_row_windows_are_the_whole_batchs(loss):
    """A loss given a rank's ``rows`` (and the whole ``batch``) draws the
    whole batch's one-key noise and keeps its rows: the rows' outputs are the
    whole run's rows and the mean of the two halves' means is the whole
    batch's, within 1e-12 in float64.  The losses take the window as an
    argument and never read the ambient mesh: under one, a call without
    ``rows`` is bitwise the call without a mesh."""
    rows_whole, means_whole = _loss_of_rows(loss, None)
    halves = [_loss_of_rows(loss, w) for w in ((0, 4), (4, 8))]
    for i, whole in enumerate(rows_whole):
        torch.testing.assert_close(torch.cat([h[0][i] for h in halves], 1), whole,
                                   rtol=F64_REL, atol=F64_REL)
    for i, whole in enumerate(means_whole):
        _rel_close(0.5 * (halves[0][1][i] + halves[1][1][i]), whole, F64_REL)
    with compat.set_mesh(compat.abstract_mesh((2,), ("data",))):
        rows_mesh, means_mesh = _loss_of_rows(loss, None)
    for a, b in zip(rows_mesh + means_mesh, rows_whole + means_whole):
        assert torch.equal(_bits(a), _bits(b))


def test_unwindowed_draw_keeps_its_bits():
    """The window (0, whole) is the unwindowed draw, bit for bit; a window
    needs one key."""
    key = prng.PRNGKey(8)
    whole = ref.brownian_increment(key[0], key[1], 4, (3, 7), torch.float32, 0.25)
    same = ref.brownian_increment(key[0], key[1], 4, (3, 7), torch.float32, 0.25, (0, 21))
    assert torch.equal(_bits(whole), _bits(same))


# ---------------------------------------------------------------------------
# the rule tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _meta_params(arch: str):
    """The architecture's full-size parameters as meta tensors (shapes and
    dtypes only; the initialisers' draws replaced by empty meta tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, transformer

    real = layers._normal
    layers._normal = lambda g, shape, dtype, device: torch.empty(tuple(shape), dtype=dtype,
                                                                 device="meta")
    try:
        return transformer.init_lm(torch.Generator(), get_config(arch), device="meta")
    finally:
        layers._normal = real


def _leaves_with_names(params, *like, name=""):
    """``(name, leaf, *like's entries at that leaf)`` over ``params``'s
    leaves, ``like`` trees of its structure whose leaves are tuples."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves_with_names(params[k], *(t[k] for t in like), name=k)
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves_with_names(v, *(t[i] for t in like), name=name)
    else:
        yield (name, params, *like)


def _norm(entry):
    """A spec entry compared as a tuple of axis names (or None)."""
    if entry is None:
        return None
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


MESHES = [((2, 16, 16), ("pod", "data", "model")), ((16, 16), ("data", "model"))]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2.5-14b", "starcoder2-3b",
                                  "tinyllama-1.1b"])
def test_param_specs_equal_the_reference_rules(arch, mesh):
    shape, names = mesh
    sizes = dict(zip(names, shape))
    params = _meta_params(arch)
    with compat.set_mesh(compat.abstract_mesh(shape, names)):
        specs = sharding.param_specs(params)
        pure = sharding.param_specs(params, serve_pure_tp=True)
        places = sharding.param_pspecs(params)
    for name, leaf, spec, spec_tp, place in _leaves_with_names(params, specs, pure, places):
        assert leaf.device.type == "meta"
        want = tuple(jax_sharding._spec_for(name, tuple(leaf.shape), names, sizes, False))
        assert [_norm(e) for e in spec] == [_norm(e) for e in want], name
        assert all(e is None or "pod" not in _norm(e) and "data" not in _norm(e)
                   for e in spec_tp), name
        assert len(place) == len(names)
        for axis, p in zip(names, place):
            dims = [d for d, e in enumerate(spec) if e is not None and axis in _norm(e)]
            assert (p.is_shard() and p.dim == dims[0]) if dims else p.is_replicate()


def test_param_specs_fall_back_where_an_axis_does_not_divide():
    """The reference's divisibility fallback: an entry whose axis product
    does not divide the dim replicates that dim (vocab 73448 on a 16-way
    model axis); no mesh replicates everything."""
    params = {"embed": torch.empty(73448, 2560, device="meta"),
              "head": torch.empty(2560, 73448, device="meta"),
              "wq": torch.empty(4, 2560, 4096, device="meta"),
              "g": torch.empty(2560, device="meta")}
    names, shape = ("data", "model"), (16, 16)
    with compat.set_mesh(compat.abstract_mesh(shape, names)):
        specs = sharding.param_specs(params)
    for name, leaf in params.items():
        want = jax_sharding._spec_for(name, tuple(leaf.shape), names, dict(zip(names, shape)),
                                      False)
        assert [_norm(e) for e in specs[name]] == [_norm(e) for e in want]
    assert specs["embed"][0] is None and specs["head"][1] is None
    assert specs["wq"] == (None, ("data",), "model") and specs["g"] == ()
    assert sharding.param_specs(params)["wq"] == (None, None, None)


def test_production_mesh_plans_without_a_process_group():
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.device_mesh is None
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert tmesh.make_mesh_from_devices(40).shape == {"data": 2, "model": 16}
    with compat.set_mesh(multi):
        assert sharding.active_mesh_axes() == ("pod", "data", "model")
        assert sharding.dp_axes() == ("pod", "data") and sharding.tp_axis() == "model"
        assert sharding.tp_size() == 16 and sharding.batch_pspec() == (("pod", "data"),)
        # an abstract mesh has no ranks: the data-parallel helpers stay identities
        x = torch.ones(3, 4, 2)
        assert sharding.shard_time_major(x) is x and sharding.row_window(4) is None
        assert sharding.dp_world() == 1
    assert compat.ambient_mesh() is None and sharding.data_parallel_mesh(8) is None


# ---------------------------------------------------------------------------
# the collectives, two ranks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _collectives():
    return compat.launch(R.collectives, 2, timeout=LIMIT)


def test_mesh_places_and_row_windows():
    r0, r1 = _collectives()
    assert r0["none_for_odd"] and r1["none_for_odd"]
    assert r0["mesh"] == ((2,), ("data",), (0,)) and r1["mesh"] == ((2,), ("data",), (1,))
    assert r0["dp_world"] == r1["dp_world"] == 2
    assert r0["row_window"] == (0, 4) and r1["row_window"] == (4, 8)
    x = torch.arange(3 * 8 * 2, dtype=torch.float64).reshape(3, 8, 2) / 7
    assert torch.equal(r0["time_major"], x[:, :4]) and torch.equal(r1["time_major"], x[:, 4:])


def test_row_gather_is_bitwise_on_every_dtype():
    r0, r1 = _collectives()
    x = torch.arange(3 * 8 * 2, dtype=torch.float64).reshape(3, 8, 2) / 7
    for r in (r0, r1):
        assert torch.equal(_bits(r["gathered"]), _bits(x))
        f, i, b = r["gather_kinds"]
        assert torch.equal(_bits(f[:2]), _bits(torch.full((2, 3), -0.0)))  # the sign bit kept
        assert torch.isnan(f[2:]).all()
        assert torch.equal(i, torch.tensor([[0, -1], [1, -2]]))
        assert torch.equal(b, torch.tensor([True, False, False, True]))


def test_flat_mean_broadcast_and_max_agree_on_every_rank():
    r0, r1 = _collectives()
    for a, b in zip(r0["mean"], r1["mean"]):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(r0["mean"][0], (torch.full((3,), 0.1, dtype=torch.float64)
                                       + torch.full((3,), 0.2, dtype=torch.float64)) / 2)
    assert torch.equal(r0["mean"][1], torch.full((2, 2), 1.5))
    assert r0["mean"][2].shape == ()
    assert torch.equal(r1["broadcast"], torch.zeros(4, dtype=torch.float64))
    assert r0["global_max"] == r1["global_max"] == 8


def test_a_hanging_rank_is_killed_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(compat.RanksFailed, match="did not finish within"):
        compat.launch(R.sleep_forever, 2, timeout=15.0)
    assert time.monotonic() - t0 < 120


def test_a_failing_rank_fails_the_call():
    with pytest.raises(compat.RanksFailed, match="ranks failed"):
        compat.launch(R.scheduler_drain, 2, (3,), timeout=LIMIT)  # shard_base 3 on 2 ranks


# ---------------------------------------------------------------------------
# training, two ranks against one
# ---------------------------------------------------------------------------

TRAIN_CASES = [("clip", "float32"), ("clip", "float64"), ("gp", "float32"),
               ("gp", "float64"), ("elbo", "float32"), ("elbo", "float64")]


@functools.lru_cache(maxsize=None)
def _two_ranks():
    return compat.launch(R.training_cases, 2, (TRAIN_CASES,), timeout=LIMIT)


def _rel_close(got, want, rel):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("kind,dtype", TRAIN_CASES)
def test_two_ranks_train_as_one(kind, dtype):
    one = R.training_cases([(kind, dtype)])[kind, dtype]
    ranks = [r[kind, dtype] for r in _two_ranks()]
    rel = F64_REL if dtype == "float64" else F32_REL
    for step in range(2):
        m1, p1 = one[step]
        (m_a, p_a), (m_b, p_b) = ranks[0][step], ranks[1][step]
        for a, b in zip(tree.leaves(p_a), tree.leaves(p_b)):
            assert torch.equal(_bits(a), _bits(b))  # the ranks' parameters, bitwise
        assert {k: float(v) for k, v in m_a.items()} == {k: float(v) for k, v in m_b.items()}
        for name in m1:
            _rel_close(m_a[name], m1[name], rel)
        for a, w in zip(tree.leaves(p_a), tree.leaves(p1)):
            _rel_close(a, w, rel)


@pytest.fixture
def cli_limits(monkeypatch):
    """The CLIs' ``--host-devices`` ranks wait with no time limit; here each
    launch runs within LIMIT all the same, and the limit the CLI asked for is
    recorded (the list this fixture returns)."""
    asked, real = [], compat.launch

    def bounded(fn, nprocs, args=(), device="cpu", timeout=None, quiet=True):
        asked.append(timeout)
        return real(fn, nprocs, args, device=device, timeout=LIMIT, quiet=quiet)

    monkeypatch.setattr(compat, "launch", bounded)
    return asked


@pytest.mark.parametrize("cli", [train_cli, serve_cli], ids=["train", "serve"])
def test_host_devices_runs_its_ranks_with_no_time_limit(cli, monkeypatch):
    """``--host-devices N`` reruns the CLI on N ranks without the flag and
    waits for them with no limit: a long training run or a service is not
    cut (the tests' own spawns pass theirs)."""
    calls = []

    def fake(fn, nprocs, args=(), device="cpu", timeout=None, quiet=True):
        calls.append((nprocs, args[1], device, timeout))
        return ["rank 0's result", None]

    monkeypatch.setattr(compat, "launch", fake)
    argv = ["--workload", "sde-gan", "--host-devices", "3", "--device", "cpu"]
    assert cli.main(argv) == "rank 0's result"
    assert calls == [(3, ["--workload", "sde-gan", "--device", "cpu"], "cpu", None)]


def test_train_clis_print_the_mesh_and_agree_with_one_rank(capfd, cli_limits):
    def run(workload, extra):
        argv = ["--workload", workload, "--device", "cpu", "--steps", "2", "--batch", "8",
                *extra]
        one = train_cli.main(argv)
        two = train_cli.main(argv + ["--host-devices", "2"])
        return one, two

    one, two = run("sde-gan", ["--sde-steps", "8", "--seq-len", "9"])
    out = capfd.readouterr().out
    assert "[sde-gan] data-parallel over 2 devices (gloo: ranks on the CPU)" in out
    np.testing.assert_allclose(two, one, rtol=F32_REL)
    one, two = run("latent-sde", ["--pallas"])
    out = capfd.readouterr().out
    assert "[latent-sde] data-parallel over 2 devices (gloo: ranks on the CPU)" in out
    np.testing.assert_allclose(two, one, rtol=F32_REL)
    assert cli_limits == [None, None]


def test_an_indivisible_batch_trains_unsharded_with_the_reference_message(tmp_path, capfd,
                                                                          cli_limits):
    losses = train_cli.main(["--workload", "latent-sde", "--device", "cpu", "--steps", "1",
                             "--batch", "9", "--host-devices", "2", "--ckpt-dir",
                             str(tmp_path)])
    out = capfd.readouterr().out
    assert "batch 9 not divisible by 2 devices — running unsharded" in out
    assert len(losses) == 1 and (tmp_path / "serving").exists()


# ---------------------------------------------------------------------------
# training, two ranks against the reference's two devices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_two_devices(tmp):
    out = os.path.join(tmp, "reference.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "_dp_reference.py"), out],
                          env=env, capture_output=True, text=True, timeout=LIMIT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


LOSS_TOL = dict(rtol=1e-9, atol=1e-12)  # float64, tests/test_torch_gan_train.py
GAN_PARAM_TOL = dict(rtol=1e-12, atol=math.sqrt(1e-6 / (1 - 0.9)) * 1e-6)
ELBO_PARAM_TOL = dict(rtol=1e-12, atol=1e-2 * 1e-6)  # tests/test_torch_training.py


@pytest.mark.parametrize("kind", ["clip", "elbo"])
def test_two_ranks_match_the_reference_on_two_devices(kind, tmp_path_factory):
    ref_out = _reference_two_devices(str(tmp_path_factory.getbasetemp()))
    params, key, metrics, new = ref_out[kind]
    (got_metrics, got), = compat.launch(R.one_step, 2, (kind, params_from_jax(params),
                                                        torch.from_numpy(
                                                            key.astype(np.int64))),
                                        timeout=LIMIT)[:1]
    assert sorted(got_metrics) == sorted(metrics)
    for name in metrics:
        torch.testing.assert_close(got_metrics[name], torch.from_numpy(np.array(metrics[name])),
                                   **LOSS_TOL)
    tol = GAN_PARAM_TOL if kind == "clip" else ELBO_PARAM_TOL
    for g, w in zip(tree.leaves(got), jax.tree.leaves(new)):
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(w)), **tol)


# ---------------------------------------------------------------------------
# serving, two ranks against one, bitwise
# ---------------------------------------------------------------------------

SERVE_MODES = {
    "batch": dict(max_batch=4, requests=6, request_max=3, sde_steps=8),
    "stream": dict(max_batch=4, requests=5, request_max=2, sde_steps=8, stream_chunks=4),
    "adaptive": dict(max_batch=4, requests=4, request_max=2, sde_steps=8, adaptive=True,
                     atol=1e-2),
    "scheduler": dict(max_batch=4, requests=6, request_max=3, sde_steps=8,
                      scheduler="continuous"),
    "async": dict(max_batch=4, requests=6, request_max=3, sde_steps=8, scheduler="fifo",
                  async_front=True),
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_two_rank_drains_are_the_one_rank_drains_bitwise(mode):
    kw = SERVE_MODES[mode]
    one = R.serve_samples(kw)
    two = compat.launch(R.serve_samples, 2, (kw,), timeout=LIMIT)[0]
    assert sorted(one) == sorted(two) and one
    for rid in one:
        assert torch.equal(_bits(two[rid]), _bits(one[rid])), rid


def test_sharded_scheduler_drain_is_the_one_rank_drain_bitwise():
    one = R.scheduler_drain(1)
    two = compat.launch(R.scheduler_drain, 2, (2,), timeout=LIMIT)
    assert two[1] is None and sorted(two[0]) == sorted(one) == list(range(8))
    for rid, (samples, conv) in one.items():
        got_samples, got_conv = two[0][rid]
        assert torch.equal(_bits(got_samples), _bits(samples)), rid
        assert torch.equal(got_conv, conv)


def test_serve_cli_host_devices_serves_every_request(capfd, cli_limits):
    for extra in ([], ["--scheduler", "continuous"]):
        stats = serve_cli.main(["--workload", "sde-gan", "--host-devices", "2", "--device",
                                "cpu", "--requests", "6", "--max-batch", "4", "--sde-steps",
                                "8", *extra])
        out = capfd.readouterr().out
        assert "[serve] data-parallel over 2 devices (gloo: ranks on the CPU)" in out
        assert stats["devices"] == 2 and stats["buckets"] == [2, 4]
        assert stats["trajectories"] == sum(r.size for r in synthetic_requests(6, 4, 0))
    assert cli_limits == [None, None]
