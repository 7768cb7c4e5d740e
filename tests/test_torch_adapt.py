"""The port's adaptive controller (``control/adapt.py``) and its plumbing in
``MasterProcess`` and the cluster CLI, against the JAX package's, on the CPU.

- ``AdaptiveController``s of both packages, fed one seeded observation
  sequence (a healthy baseline, a straggler's onset through lag, latency,
  restarts, noise and a starved link, a hold, a heal), return the same
  policy at every round and emit byte-identical ``decision_log_jsonl``; each
  package's ``digest`` restores into the other's controller mid-incident and
  the two go on alike. The ladder's policies and the tables are equal.
- ``MasterProcess`` arms its transport's injector and builds the controller
  (its policy stamped on the grid), a standby builds no controller until it
  takes over, and a leader-side decision reaches the grid, the digest and
  the metrics JSONL.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

import numpy as np
import pytest

import akka_allreduce_tpu.config as jconfig
import akka_allreduce_tpu.control.adapt as jadapt
import akka_allreduce_tpu_torch.config as tconfig
import akka_allreduce_tpu_torch.control.adapt as tadapt
from akka_allreduce_tpu_torch.control.bootstrap import MasterProcess
from akka_allreduce_tpu_torch.control.chaos import MASTER_ROLE, ChaosInjector

ADAPT = dict(enabled=True, window=4, min_dwell=4, lag_degrade=6, lag_restore=2,
             noise_degrade=6, bw_degrade_ratio=0.3)


def _observations(n=220, seed=0):
    """(round, lags, counters, latency, bandwidth) a round: healthy, then a
    straggler whose lag, latency, restarts, noise and starved link come and
    go, then healthy again; cumulative counters and byte gauges."""
    rng = np.random.default_rng(seed)
    counters = {"restarts": 0, "reconnects": 0, "drops": 0, "reorgs": 0}
    bw = {f"10.0.0.{k}:900{k}": 0.0 for k in range(4)}
    out = []
    for r in range(n):
        sick = 40 <= r < 140
        lags = {w: int(rng.integers(0, 2)) for w in range(4)}
        if sick:
            lags[3] = int(rng.integers(4, 12))
            counters["restarts"] += int(rng.random() < 0.15)
            counters["reconnects"] += int(rng.integers(0, 3))
            counters["drops"] += int(rng.integers(0, 2))
        counters["reorgs"] += int(r in (150, 151))
        latency = float(rng.uniform(0.01, 0.012) * (8.0 if sick and r % 3 == 0 else 1.0))
        for k, ep in enumerate(bw):
            rate = 1e6 * (0.1 if sick and k == 3 else 1.0)
            bw[ep] += rate * float(rng.uniform(0.9, 1.1))
        out.append((r, dict(lags), dict(counters), latency, dict(bw)))
    return out


def _controllers(**over):
    kw = {**ADAPT, **over}
    th = dict(th_reduce=0.9, th_complete=0.9, th_allreduce=1.0)
    return (tadapt.AdaptiveController(tconfig.AdaptConfig(**kw), tconfig.ThresholdConfig(**th)),
            jadapt.AdaptiveController(jconfig.AdaptConfig(**kw), jconfig.ThresholdConfig(**th)))


def _feed(ctl, obs):
    pols = []
    for r, lags, counters, latency, bw in obs:
        pol = ctl.observe_round(r, lags, counters, latency_s=latency, bandwidth=bw)
        pols.append(None if pol is None else dataclasses.asdict(pol))
    return pols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_jax_byte_for_byte(seed):
    ours, theirs = _controllers()
    obs = _observations(seed=seed)
    assert _feed(ours, obs) == _feed(theirs, obs)
    assert ours.decision_log_jsonl().encode() == theirs.decision_log_jsonl().encode()
    assert ours.transitions == theirs.transitions >= 2
    assert ours.level == theirs.level == 0  # healed: back to full fidelity
    assert ours.digest() == theirs.digest()
    assert ours.last_decision == theirs.last_decision
    whys = {w for d in ours.decisions for w in d["why"]}
    assert "recovered" in whys and len(whys) >= 3, whys


@pytest.mark.parametrize("cut", [60, 100])
def test_digest_restores_across_the_packages(cut):
    obs = _observations(seed=4)
    ours, theirs = _controllers()
    _feed(ours, obs[:cut]), _feed(theirs, obs[:cut])
    assert ours.level == theirs.level > 0  # mid-incident
    # a promoted standby of either package inherits the other's state
    our_standby, their_standby = _controllers()
    our_standby.restore(json.loads(json.dumps(theirs.digest())))
    their_standby.restore(json.loads(json.dumps(ours.digest())))
    assert our_standby.policy() == tadapt.AdaptiveController.policy(ours)
    assert _feed(our_standby, obs[cut:]) == _feed(their_standby, obs[cut:])
    assert our_standby.decision_log_jsonl() == their_standby.decision_log_jsonl()
    assert our_standby.digest() == their_standby.digest()
    our_standby.restore(None)  # an empty digest changes nothing
    assert our_standby.digest() == their_standby.digest()


@pytest.mark.parametrize("levels,floor", [(2, 0.5), (2, 0.7), (1, 0.95)])
def test_ladder_and_tables_match_jax(levels, floor):
    ours, theirs = _controllers(levels=levels, floor_th_reduce=floor)
    for level in range(-1, levels + 2):
        assert dataclasses.asdict(ours.policy_for_level(level)) == dataclasses.asdict(
            theirs.policy_for_level(level))
        assert ours.policy_for_level(level).describe() == theirs.policy_for_level(
            level).describe()
    assert tadapt._WIRE_LADDER == jadapt._WIRE_LADDER
    assert tadapt.WIRE_TO_COMPRESS == jadapt.WIRE_TO_COMPRESS
    assert tadapt.COUNTER_EVIDENCE == jadapt.COUNTER_EVIDENCE


def test_decision_log_file_and_deciding_next(tmp_path):
    ours, theirs = _controllers()
    obs = _observations(seed=3)
    flags = []
    for r, lags, counters, latency, bw in obs[:9]:
        flags.append(ours.deciding_next)
        ours.observe_round(r, lags, counters, latency_s=latency, bandwidth=bw)
    assert flags == [False, False, False, True] * 2 + [False]
    _feed(theirs, obs[:9])
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    ours.write_log(str(a)), theirs.write_log(str(b))
    assert a.read_bytes() == b.read_bytes()


# -- the master's plumbing -----------------------------------------------------


def _master_config(**kw):
    return tconfig.AllreduceConfig(
        threshold=tconfig.ThresholdConfig(0.75, 0.75, 0.75),
        metadata=tconfig.MetaDataConfig(data_size=1000, max_chunk_size=128),
        master=tconfig.MasterConfig(node_num=2, heartbeat_interval_s=0.2),
        **kw,
    )


def test_master_arms_the_injector_and_the_controller():
    cfg = _master_config(chaos=tconfig.ChaosConfig(seed=9, spec="drop:p=0.1"),
                         adapt=tconfig.AdaptConfig(**ADAPT))
    master = MasterProcess(cfg, port=0, chaos_log="m.jsonl")
    inj = master.transport.chaos
    assert isinstance(inj, ChaosInjector)
    assert (inj.seed, inj.spec, inj.role, inj.allow_crash, inj.log_path) == (
        9, "drop:p=0.1", MASTER_ROLE, False, "m.jsonl")
    assert isinstance(master.adapt, tadapt.AdaptiveController)
    assert master.adapt.config == cfg.adapt and master.grid.on_round_complete is not None
    # a standby builds no controller until it takes over
    from akka_allreduce_tpu_torch.control.cluster import Endpoint

    standby = MasterProcess(cfg, port=0, standby_of=Endpoint("127.0.0.1", 1))
    assert standby.adapt is None
    plain = MasterProcess(_master_config(), port=0)
    assert plain.transport.chaos is None and plain.adapt is None


def test_a_leader_decision_reaches_the_grid_and_the_metrics(tmp_path):
    """The master feeds its controller once per completed line-round; a
    degrade is stamped on the grid and logged as an ``adapt`` event."""
    from akka_allreduce_tpu_torch.utils.metrics import MetricsLogger

    async def run():
        cfg = _master_config(adapt=tconfig.AdaptConfig(enabled=True, window=2, min_dwell=0,
                                                       lag_degrade=3, lag_restore=1))
        path = tmp_path / "rounds.jsonl"
        metrics = MetricsLogger(str(path))
        master = MasterProcess(cfg, port=0, metrics=metrics)
        master.grid.worker_lags = lambda: {0: 0, 1: 5}  # a straggling worker
        master._on_round_complete(0, 0, 0.01, 2, 2)
        assert master.adapt.level == 0
        master._on_round_complete(0, 1, 0.01, 2, 2)
        assert master.adapt.level == 1
        assert master.grid.policy == master.adapt.policy()
        metrics.close()
        events = [json.loads(ln) for ln in path.read_text().splitlines()]
        adapt = [e for e in events if e["kind"] == "adapt"]
        # the registry counters are process-wide: other evidence may join the lag
        assert len(adapt) == 1 and adapt[0]["to"] == 1 and "lag" in adapt[0]["why"]
        assert master.adapt.digest()["level"] == 1
        assert json.loads(master._digest_state())["round"]["adapt"]["level"] == 1

    asyncio.run(asyncio.wait_for(run(), 30.0))
