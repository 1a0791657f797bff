"""PyTorch port: the data axis, rank-block draws and the train-state shard
(parallel/mesh, device, parallel/train) in one process.

A rank's block of an axis is the JAX package's ``NamedSharding(mesh,
P("data"))`` shard of its device; a rank-block generator draws the rows of the
global draw, and on a plain generator the helpers are torch's own draws bit
for bit; the shard of a world-1 ``TrainState`` holds each env-axis leaf's
block and everything shared whole, on the flat config, the sampled heightmap
and the analytic terrain. The two-process runs are in
``tests/test_torch_distributed.py``.
"""

import dataclasses
import os

import jax
import pytest
import torch
import torch.distributed as dist

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as tdev
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import train as ttrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb as tsrb
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import mesh as tmesh
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import train as tptrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as tterrain
from high_speed_quadrupedal_locomotion_by_irrl_tpu.parallel import mesh as jmesh

torch.set_num_threads(1)

TORCH_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "high_speed_quadrupedal_locomotion_by_irrl_torch")
CPU = torch.device("cpu")


def fake_mesh(world: int, rank: int) -> tmesh.Mesh:
    """A rank's view without a process group: enough for the block arithmetic."""
    return tmesh.Mesh(world=world, rank=rank, device=CPU, backend="gloo")


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_block_is_the_jax_data_shard_of_each_device(world):
    """block(mesh, 16) of rank r == the index map of NamedSharding(P("data"))
    over the first W of the conftest's 8 CPU devices, at device r."""
    jm = jmesh.make_mesh(jax.devices()[:world])
    index = jmesh.data_sharding(jm).devices_indices_map((16,))
    for r, d in enumerate(jm.devices.flat):
        sl = index[d][0]
        assert tmesh.block(fake_mesh(world, r), 16) == (sl.start or 0, 16 if sl.stop is None
                                                        else sl.stop)
    blocks = [tmesh.block(fake_mesh(world, r), 16) for r in range(world)]
    assert blocks[0][0] == 0 and blocks[-1][1] == 16
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


def _draws(gen, rows: int, n: int, device=CPU):
    return [tdev.rand(gen, (rows, 3), device), tdev.randn(gen, (rows, 12), device),
            tdev.rand(gen, (rows,), device), tdev.randperm(gen, n, device),
            tdev.randn(gen, (rows, 2, 3), device, torch.float64)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_block_draws_are_the_rows_of_the_global_draw(world):
    n, seed = 8, 5
    want = _draws(torch.Generator().manual_seed(seed), n, n)
    for r in range(world):
        lo, hi = tmesh.block_range(r, world, n)
        got = _draws(tdev.RankBlock(torch.Generator().manual_seed(seed), lo, hi, n), hi - lo, n)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w if i == 3 else w[lo:hi]), (r, i)
    if world == 1:   # on a plain generator the helpers are torch's own draws, bit for bit
        g = torch.Generator().manual_seed(seed)
        plain = [torch.rand((n, 3), generator=g), torch.randn((n, 12), generator=g),
                 torch.rand((n,), generator=g), torch.randperm(n, generator=g),
                 torch.randn((n, 2, 3), generator=g, dtype=torch.float64)]
        assert all(torch.equal(a, b) for a, b in zip(want, plain))


def test_row_product_gives_a_row_the_same_bits_at_any_width():
    """The rollout's heads (models/lstm.row_product): x @ w to rounding, and
    each row's bits the same whether it is computed among 1024 rows or fewer."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1024, 48, generator=g)
    for n in (12, 1):
        w = 0.3 * torch.randn(48, n, generator=g)
        full = tlstm.row_product(x, w)
        torch.testing.assert_close(full, x @ w, atol=1e-5, rtol=1e-5)
        for width in (512, 256, 200, 24, 5, 1):
            for lo in (0, 1024 - width):
                assert torch.equal(tlstm.row_product(x[lo:lo + width], w), full[lo:lo + width])
    params = tlstm.init(torch.Generator().manual_seed(1), n_lstm=(8, 8), device="cpu")
    obs, dones = torch.randn(64, 35, generator=g), torch.zeros(64)
    state = torch.zeros(64, tlstm.state_size((8, 8)))
    out = tlstm.forward(params, obs, state, dones, stable_rows=True)
    part = tlstm.forward(params, obs[40:45], state[40:45], dones[40:45], stable_rows=True)
    for a, b in ((out.mean, part.mean), (out.value, part.value), (out.state, part.state)):
        assert torch.equal(a[40:45], b)


def _terrain_cfg(kind: str):
    if kind == "flat":
        return tconfig.train_default()
    cfg = tconfig.from_yaml(os.path.join(TORCH_PKG, "configs", "bp5_relax_terrain.yaml"))
    return cfg if kind == "heightmap" else cfg.replace(terrain_sampled=False)


def _env_leaves(state: tbp.EnvState) -> dict:
    """Every tensor of an EnvState by name, those of its params and terrain too."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k.name}": getattr(v, k.name) for k in dataclasses.fields(v)})
        elif v is not None:
            out.update({f"{f.name}.{k}": t for k, t in v._asdict().items()})
    return out


def _clone(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


@pytest.mark.parametrize("kind", ["flat", "heightmap", "analytic"])
def test_shard_train_state_keeps_each_env_block_and_the_shared_leaves(kind):
    """Rank r of W holds block r of every env-axis leaf of the world-1 state
    (per-env robot params and terrain included) and the policy, the optimizer
    and an unbatched robot whole; its generators are blocks of the same
    generators, so a reset of the shard (obs noise on) is the block of the
    world-1 reset."""
    cfg = _terrain_cfg(kind).replace(num_envs=8)
    assert cfg.obs_noise > 0 and cfg.stochastic_dynamics
    ts = tppo.init_train_state(cfg, tppo.PPOConfig(n_lstm=(8, 8)), 3, device="cpu")
    terr = ts.env_state.terrain
    assert (terr is None) == (kind == "flat")
    assert isinstance(terr, {"flat": type(None), "heightmap": tterrain.SampledTerrain,
                             "analytic": tterrain.TerrainParams}[kind])
    full = _env_leaves(ts.env_state)
    assert all(t.shape[0] == 8 for t in full.values())
    want_reset = tbp.reset(cfg, ts.env_state, _clone(ts.gen_env))
    for world in (2, 4):
        for r in range(world):
            lo, hi = tmesh.block_range(r, world, 8)
            sh = tptrain.shard_train_state(fake_mesh(world, r), ts.replace(
                gen_env=_clone(ts.gen_env)))
            assert sh.params is ts.params and sh.opt_state is ts.opt_state
            for g in (sh.gen_env, sh.gen_train):
                assert isinstance(g, tdev.RankBlock) and (g.lo, g.hi, g.total) == (lo, hi, 8)
            for name in ("lstm_state", "obs", "dones"):
                assert torch.equal(getattr(sh, name), getattr(ts, name)[lo:hi]), name
            part = _env_leaves(sh.env_state)
            assert part.keys() == full.keys()
            for k, t in full.items():
                assert torch.equal(part[k], t[lo:hi]), k
            got = _env_leaves(tbp.reset(cfg, sh.env_state, sh.gen_env))
            for k, t in _env_leaves(want_reset).items():
                assert torch.equal(got[k], t[lo:hi]), k
    # one robot for every env (the MPC's nominal params) is a shared leaf: kept whole
    nominal = tmdl.nominal_params(cfg, "cpu")
    sh = tptrain.shard_env_state(ts.env_state.replace(params=nominal), 2, 4, 8)
    assert sh.params is nominal and sh.gc.shape[0] == 2


def test_what_distributed_refuses(tmp_path):
    """--terrain-z-curriculum under --distributed raises before any process
    group or run directory (JAX ignores it there); envs or problems that do
    not split evenly over the ranks raise, as JAX's asserts; a block draw
    must lead with its envs."""
    with pytest.raises(NotImplementedError, match="--terrain-z-curriculum.*--distributed"):
        ttrain.main(["--device", "cpu", "--distributed", "--num-envs", "4", "--log-dir",
                     str(tmp_path), "--cfg", os.path.join(TORCH_PKG, "configs",
                                                          "bp5_relax_terrain.yaml"),
                     "--terrain-z-curriculum", "0.05,0.1"])
    assert not os.listdir(tmp_path) and not dist.is_initialized()
    cfg = tconfig.train_default().replace(num_envs=16)
    m3 = fake_mesh(3, 0)
    with pytest.raises(ValueError, match="divide evenly across the 3 ranks"):
        tptrain.make_distributed_update(cfg, tppo.PPOConfig(), m3)
    with pytest.raises(ValueError, match="do not split evenly over 3"):
        tmesh.block(m3, 16)
    probs = tsrb.standing_problem(tconfig.test_default(), torch.zeros(16, 3))
    with pytest.raises(ValueError, match="do not split evenly over 3"):
        tptrain.make_distributed_srb(tconfig.test_default(), tsrb.SRBConfig(horizon=4), m3)(probs)
    blk = tdev.RankBlock(torch.Generator(), 4, 8, 16)
    with pytest.raises(ValueError, match="must lead with its 4 envs"):
        tdev.rand(blk, (16, 3))
    with pytest.raises(ValueError, match="must be of 16"):
        tdev.randperm(blk, 4)
    with pytest.raises(RuntimeError, match="call init_distributed first"):
        tmesh.make_mesh()
