"""The port's ``MCLNode`` and ``MCLConfig``: the configuration from a
ParamTree against the JAX package's, the copied ParamTree, the spread
metrics, the budget rungs and the compact slice against the JAX node's on
the same state, the engine gate and the budget audit, and a short tracking
run with the port's own generator that converges."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmcl_tpu.config.tree import ParamTree as JPT
from rmcl_tpu.config.tree import _mini_yaml as j_mini_yaml
from rmcl_tpu.mcl import node as jnode
from rmcl_tpu_torch.bvh.bins import build_bins
from rmcl_tpu_torch.bvh.builder import build_bvh
from rmcl_tpu_torch.config.tree import ParamTree as TPT
from rmcl_tpu_torch.config.tree import _mini_yaml as t_mini_yaml
from rmcl_tpu_torch.geom.mesh import make_room_scene
from rmcl_tpu_torch.math.se3 import Transform
from rmcl_tpu_torch.mcl import node as tnode
from rmcl_tpu_torch.mcl.resampling import ResamplerConfig
from rmcl_tpu_torch.mcl.sensor_update import SensorUpdateConfig
from rmcl_tpu_torch.sensors.models import SphericalModel
from rmcl_tpu_torch.sensors.simulate import simulate

from test_torch_mcl import _clouds

torch.set_num_threads(2)

YAML = """
max_particles: 4096
seed: 7
motion_update:
  forget_rate: 0.4
  check_collisions: true
sensor_update:
  correspondence_type: 1
  samples: 64
  dist_sigma: 0.5
  sensor_range_max: 40.0
  engine: binned
  c_super: 32
  c_mid: 16
  layout: particle
  auto_engine_period: 2
resampling:
  type: residual
  min_noise_tx: 0.02
  min_noise_yaw: 0.05
  likelihood_forget_per_meter: 0.25
  dynamic_count: adaptive
  max_induction_particles: 1000
"""


def _as_plain(x):
    """A config value as plain Python values: a dict for a dataclass, lists
    of floats for arrays and tuples (JAX keeps numbers as float32 arrays)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _as_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (str, bool)):
        return x
    return np.asarray(x, dtype=np.float64).tolist()


def test_config_from_params_matches_jax():
    jc = _as_plain(jnode.MCLConfig.from_params(JPT.from_yaml(YAML)))
    tc = _as_plain(tnode.MCLConfig.from_params(TPT.from_yaml(YAML)))
    assert jc.keys() == tc.keys()
    for name, a in jc.items():
        b = tc[name]
        if isinstance(a, dict):
            assert a.keys() == b.keys(), name
            for k in a:
                if isinstance(a[k], str) or isinstance(a[k], bool):
                    assert a[k] == b[k], f"{name}.{k}"
                else:
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=f"{name}.{k}")
        else:
            assert a == b, name
    t = tnode.MCLConfig.from_params(TPT.from_yaml(YAML))
    assert t.sensor.correspondence_type == "CP" and t.resampler == "residual"
    with pytest.raises(ValueError):
        tnode.MCLConfig.from_params(TPT({"resampling": {"type": "stratified"}}))


def test_param_tree_matches_jax():
    flat = {"a.b": 1, "a.c.d": [1, 2], "e": "x"}
    for PT in (JPT, TPT):
        t = PT.from_flat(flat)
        assert t.get("a.c.d") == [1, 2] and t.require("e") == "x"
        assert "a.b" in t and "a.z" not in t
    assert JPT.from_yaml(YAML).to_dict() == TPT.from_yaml(YAML).to_dict()
    assert j_mini_yaml(YAML) == t_mini_yaml(YAML)
    t, j = TPT.from_flat(flat), JPT.from_flat(flat)
    assert list(t.leaves()) == list(j.leaves())
    assert [k for k, _ in t.items()] == [k for k, _ in j.items()]
    over = {"a": {"b": 5}}
    assert t.merged(TPT(over)).to_dict() == j.merged(JPT(over)).to_dict()
    sub = t.subtree("a")
    sub.set("b", 9)
    assert t.get("a.b") == 1  # a derived tree never aliases its parent
    with pytest.raises(FileNotFoundError):
        TPT.from_yaml("missing.yaml")


@pytest.mark.parametrize("spread", [None, 0.3])
def test_spread_metrics_match_jax(spread):
    jc, tc = _clouds(n=400, spread=spread)
    j = np.asarray(jnode.MCLNode._spread_metrics(jc))
    t = tnode.MCLNode._spread_metrics(tc).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


def test_budget_rung_matches_jax():
    for cs, cb in ((24, 96), (48, 256), (49, 100), (60, 1500), (150, 300), (300, 5000)):
        assert tnode.MCLNode._budget_rung(cs, cb) == jnode.MCLNode._budget_rung(cs, cb)


class _State:
    """The attributes that ``_compact_slice`` reads."""

    def __init__(self, config, n_alive):
        self.config, self.n_alive_host = config, n_alive


@pytest.mark.parametrize("dynamic,compact,n_alive", [
    ("off", True, 100), ("adaptive", True, 100), ("adaptive", False, 100),
    ("reference", True, 1000), ("adaptive", True, 3), ("adaptive", True, 513),
    ("adaptive", True, None),
])
def test_compact_slice_matches_jax(dynamic, compact, n_alive):
    kw = dict(n_particles=1000, dynamic_count=dynamic, compact_compute=compact)
    j = jnode.MCLNode._compact_slice(_State(jnode.MCLConfig(**kw), n_alive))
    t = tnode.MCLNode._compact_slice(_State(tnode.MCLConfig(**kw), n_alive))
    assert j == t


def _room():
    return build_bvh(make_room_scene(n_pillars=3, seed=21), device="cpu")


def _scan(bvh, pose):
    model = SphericalModel.create(width=180, height=8, phi_min=-0.3, phi_max=0.2,
                                  range_max=30.0)
    hits = simulate(bvh, model, Transform.from_pose_tuple(pose, device="cpu"))
    return hits.point, hits.hit


def test_node_tracking_converges():
    """A robot drives +x at 0.5 m a step; odometry is exact. The JAX
    package's criterion (tests/test_mcl.py): the estimate ends within 0.25 m
    of the truth, here with the port's own generator."""
    bvh = _room()
    cfg = tnode.MCLConfig(
        n_particles=2048, sensor=SensorUpdateConfig.create(samples=48, dist_sigma=0.3),
        resampling=ResamplerConfig.create(min_noise_t=(0.03, 0.03, 0.01),
                                          min_noise_r=(0.003, 0.003, 0.01)),
        seed=5)
    node = tnode.MCLNode(bvh, cfg)
    node.warm(1440)  # nothing to build on the CPU
    node.initial_pose_guess(Transform.from_pose_tuple([0.0, 0.0, 1.0, 0, 0, 0], device="cpu"),
                            torch.diag(torch.tensor([0.04, 0.04, 0.01, 1e-4, 1e-4, 0.01])))
    for i in range(8):
        t = 0.5 * (i + 1)
        tbo = Transform.from_pose_tuple([t, 0.0, 1.0, 0, 0, 0], device="cpu")
        points, mask = _scan(bvh, [t, 0.0, 1.0, 0, 0, 0])
        node.motion_update(tbo, stamp=float(i) * 0.1)
        node.sensor_update(points, mask, Transform.identity(device="cpu"))
        node.resample()
    err = float(torch.linalg.norm(node.estimate().pose.trans - torch.tensor([4.0, 0.0, 1.0])))
    assert err < 0.25, err
    assert node.sensor_updates == 8 and node.motion_updates == 7
    assert node.ess() > 1.0
    tom = node.pose_map_odom(Transform.from_pose_tuple([4.0, 0, 1.0, 0, 0, 0], device="cpu"))
    assert float(torch.linalg.norm(tom.trans)) < 0.5
    assert {"motion_update", "sensor_update", "resampling"} <= set(node.timer.total)


def test_global_localization_fills_the_box():
    node = tnode.MCLNode(_room(), tnode.MCLConfig(n_particles=500, seed=1))
    node.global_localization([-2, -1, 0.5, 0, 0, -3.1], [2, 1, 1.5, 0, 0, 3.1])
    t = node.cloud.poses.trans
    assert bool((t[:, 0].abs() <= 2).all() & (t[:, 2] >= 0.5).all() & (t[:, 2] <= 1.5).all())
    assert not node.resample()  # guarded: no motion or sensor update yet


# the sensor's pose in the building's rooms for the binned node's scans
POSE = [3.1, 2.9, 1.5, 0, 0, 0]


@pytest.fixture
def binned_node():
    """A node on a small building (4,136 faces in 517 bins of 8, 33 supers
    of 16, mids of 4) with budgets far too small for it."""
    from rmcl_tpu_torch.geom.map import MeshMap
    from rmcl_tpu_torch.geom.mesh import make_building_scene

    mesh = make_building_scene(subdiv=4)
    mm = MeshMap(mesh=mesh, bvh=build_bvh(mesh, device="cpu"),
                 bins=build_bins(mesh, bin_size=8, bins_per_super=16, bins_per_mid=4,
                                 device="cpu"))
    cfg = tnode.MCLConfig(
        n_particles=512, seed=3, auto_engine_period=1,
        sensor=SensorUpdateConfig.create(samples=32, dist_sigma=0.3, engine="auto",
                                         c_super=2, c_bin=8))
    return tnode.MCLNode(mm, cfg), mm


def test_auto_engine_flips_and_the_audit_adopts_budgets(binned_node):
    """engine="auto" on the CPU keeps the JAX package's gate (on the card RC
    takes the exact walk for every cloud: ``tests/test_torch_cuda.py``): a
    scattered cloud stays on the exact walk; a concentrated one flips to
    the binned engine, whose first update audits the (too small) budgets
    and adopts a rung that no longer saturates."""
    node, mm = binned_node
    box = ([0.5, 0.5, 1.5, 0, 0, -3.1], [12, 9, 1.5, 0, 0, 3.1])
    node.global_localization(*box)
    points, mask = _scan(mm.bvh, POSE)
    tsb = Transform.identity(device="cpu")
    node.sensor_update(points, mask, tsb)
    assert node._engine_choice == "bvh" and node.last_audit is None
    node.initial_pose_guess(Transform.from_pose_tuple(POSE, device="cpu"),
                            torch.diag(torch.tensor([1e-3, 1e-3, 1e-4, 1e-6, 1e-6, 1e-4])))
    node.sensor_update(points, mask, tsb)
    assert node._engine_choice == "binned"
    audit = node.last_audit
    assert audit["adopted"] and audit["sat_fraction"] > 0
    cfg = node.config.sensor
    assert (cfg.c_super, cfg.c_bin) in tnode.MCLNode._BUDGET_RUNGS
    from rmcl_tpu_torch.mcl.sensor_update import probe_update_rays
    from rmcl_tpu_torch.ops.raycast_binned import block_cull_stats

    gen = torch.Generator().manual_seed(node.config.seed ^ 0x5AFE)
    o, d, t = probe_update_rays(node.cloud, gen, points, mask, tsb, cfg)
    _, sat = block_cull_stats(mm.bins, o, d, t_max=t, c_super=cfg.c_super, c_bin=cfg.c_bin,
                              c_mid=cfg.c_mid)
    assert not bool(sat.any())
    # a re-scattered cloud flips back to the exact walk (2x hysteresis)
    node.global_localization(*box)
    node.sensor_update(points, mask, tsb)
    assert node._engine_choice == "bvh"


class _Gate:
    """The attributes that ``_auto_select_engine`` reads and writes, with
    the spreads that ``_spread_metrics`` would read back."""

    def __init__(self, config, prev, spreads, updates=0, seen=False, device="cpu"):
        self.bins, self.cloud, self.device = object(), None, torch.device(device)
        self.config, self._engine_choice, self._spreads = config, prev, spreads
        self.sensor_updates, self._engine_gate_seen = updates, seen
        self._budget_checked = True

    def _spread_metrics(self, cloud):
        return torch.tensor(self._spreads, dtype=torch.float32)


# (spread, heading spread) about the default thresholds 1.0 and 0.1: inside,
# on them, in the hysteresis band, past twice them
SPREADS = [(0.05, 0.01), (0.99, 0.099), (1.0, 0.05), (0.5, 0.1), (1.5, 0.05), (0.5, 0.15),
           (2.0, 0.2), (2.5, 0.05), (0.5, 0.25), (30.0, 1.0)]
GATE = dict(auto_engine_spread=1.0, auto_engine_heading_spread=0.1, auto_engine_period=2)


def _gates(corr, prev, spreads, updates=0, seen=False, device="cpu"):
    """The JAX node's gate and the port's, each run once on the same state;
    the port's config holds the correspondence type ``corr``."""
    j = _Gate(jnode.MCLConfig(**GATE), prev, spreads, updates, seen)
    t = _Gate(tnode.MCLConfig(**GATE, sensor=SensorUpdateConfig.create(
        correspondence_type=corr)), prev, spreads, updates, seen, device)
    jnode.MCLNode._auto_select_engine(j)
    tnode.MCLNode._auto_select_engine(t)
    return j, t


@pytest.mark.parametrize("prev", ["bvh", "binned"])
@pytest.mark.parametrize("spreads", [(5.0, 0.8), (0.05, 0.01), (None, None)])
def test_auto_engine_on_the_card_is_the_exact_walk(prev, spreads):
    """An RC update on a CUDA map takes the exact BVH walk for a scattered
    cloud and a concentrated one alike, whatever the previous choice, and
    reads no spreads back."""
    t = _Gate(tnode.MCLConfig(**GATE), prev, spreads, device="cuda")
    t._spread_metrics = lambda cloud: pytest.fail("the card's rule read the spreads back")
    tnode.MCLNode._auto_select_engine(t)
    assert t._engine_choice == "bvh"
    # off the card the same cloud goes through the gate
    if None not in spreads:
        _, cpu = _gates("RC", prev, spreads)
        assert cpu._engine_choice == tnode.auto_engine(prev, *spreads, 1.0, 0.1)


@pytest.mark.parametrize("prev", ["bvh", "binned"])
@pytest.mark.parametrize("spreads", SPREADS)
def test_auto_engine_for_cp_on_the_card_is_jaxs_gate(prev, spreads):
    """A CP update on a CUDA map keeps the JAX node's gate: the same choice
    on the same spreads, with the 2x hysteresis and a fresh audit on a flip
    to binned."""
    j, t = _gates("CP", prev, spreads, device="cuda")
    assert (t._engine_choice, t._budget_checked, t._engine_gate_seen) == (
        j._engine_choice, j._budget_checked, j._engine_gate_seen)


@pytest.mark.parametrize("prev", ["bvh", "binned"])
@pytest.mark.parametrize("spreads", SPREADS)
@pytest.mark.parametrize("updates,seen", [(0, False), (3, True), (4, True)])
def test_auto_engine_off_the_card_is_jaxs_gate(prev, spreads, updates, seen):
    """Off the card the port's rule and gate choose as the JAX node's gate
    on the same spreads: 2x hysteresis from binned, the period (2 here), a
    fresh audit on a flip to binned."""
    j, t = _gates("RC", prev, spreads, updates, seen)
    assert (t._engine_choice, t._budget_checked, t._engine_gate_seen) == (
        j._engine_choice, j._budget_checked, j._engine_gate_seen)
    # the rule alone against the JAX gate evaluated now (the first update)
    now, _ = _gates("RC", prev, spreads)
    s, h = (float(x) for x in torch.tensor(spreads, dtype=torch.float32))
    assert tnode.auto_engine(prev, s, h, 1.0, 0.1) == now._engine_choice


def test_engine_counter_counts_each_update(binned_node):
    """With tracing on, ``rmcl.mcl.engine.<engine>`` counts one for each
    sensor update, under the engine the update ran."""
    from rmcl_tpu_torch.utils import timing

    node, mm = binned_node
    points, mask = _scan(mm.bvh, POSE)
    tsb = Transform.identity(device="cpu")
    timing.set_tracing(True)
    try:
        node.global_localization([0.5, 0.5, 1.5, 0, 0, -3.1], [12, 9, 1.5, 0, 0, 3.1])
        node.sensor_update(points, mask, tsb)
        node.initial_pose_guess(Transform.from_pose_tuple(POSE, device="cpu"),
                                torch.diag(torch.tensor([1e-3, 1e-3, 1e-4, 1e-6, 1e-6, 1e-4])))
        for _ in range(2):
            node.sensor_update(points, mask, tsb)
        counts = timing.counters()
    finally:
        timing.set_tracing(False)
    assert node._engine_choice == "binned"
    assert {k: v for k, v in counts.items() if k.startswith("rmcl.mcl.engine.")} == {
        "rmcl.mcl.engine.bvh": 1, "rmcl.mcl.engine.binned": 2}


def test_dynamic_count_resamples_the_live_prefix(binned_node):
    node, mm = binned_node
    node.config = dataclasses.replace(node.config, dynamic_count="adaptive", resampler="residual",
                                      adaptive_n_min=64,
                                      sensor=dataclasses.replace(node.config.sensor,
                                                                 engine="bvh"))
    node.initial_pose_guess(Transform.from_pose_tuple(POSE, device="cpu"),
                            torch.diag(torch.tensor([1e-2, 1e-2, 1e-4, 1e-6, 1e-6, 1e-3])))
    points, mask = _scan(mm.bvh, POSE)
    tsb = Transform.identity(device="cpu")
    node.motion_update(Transform.identity(device="cpu"), 0.0)
    node.motion_update(Transform.from_pose_tuple([0.01, 0, 0, 0, 0, 0], device="cpu"), 0.1)
    node.sensor_update(points, mask, tsb)
    assert node.resample()
    n = node.n_alive_host
    assert 64 <= n < 512 and int(node.cloud.n_alive) == n and bool(node.cloud.alive[:n].all())
    k = node._compact_slice()
    assert k == 1 << (n - 1).bit_length()
    before = node.cloud.likelihood.mean.clone()
    node.sensor_update(points, mask, tsb)
    assert torch.equal(node.cloud.likelihood.mean[k:], before[k:])  # only the prefix is cast
    assert not torch.equal(node.cloud.likelihood.mean[:k], before[:k])


def test_audit_raises_the_hyper_budget(binned_node):
    """With the hyper level on (c_hyper 1: 8 supers), an adopted rung's
    c_super would outgrow the hypers kept: the audit raises c_hyper to
    ceil(c_super / H), so the next casts run (the JAX node keeps c_hyper,
    and its cull's top_k fails there)."""
    node, mm = binned_node
    node.config = dataclasses.replace(
        node.config, sensor=dataclasses.replace(node.config.sensor, engine="binned", c_hyper=1))
    node.initial_pose_guess(Transform.from_pose_tuple(POSE, device="cpu"),
                            torch.diag(torch.tensor([1e-3, 1e-3, 1e-4, 1e-6, 1e-6, 1e-4])))
    points, mask = _scan(mm.bvh, POSE)
    tsb = Transform.identity(device="cpu")
    node.sensor_update(points, mask, tsb)
    cfg, H = node.config.sensor, mm.bins.supers_per_hyper
    assert node.last_audit["adopted"] and cfg.c_super > H
    assert cfg.c_hyper == -(-cfg.c_super // H) == node.last_audit["c_hyper"]
    node.sensor_update(points, mask, tsb)  # the adopted budgets cast
    assert node.sensor_updates == 2
