"""The port's planner — KMeans / affinity-propagation clustering, GMM
straggler selection, the throughput cost model — and ``plan_clusters``
against the JAX package's, on the CPU.

Both are numpy on the same seeds, so every comparison is exact: labels,
cluster sizes, thresholds (as float64, ``==``), keep-masks, rates,
walls, cuts and the whole :class:`ClusterPlan` list (cluster ids, cuts,
members per stage, label counts, rejected clients).  Inputs come from
numpy seeds, drawn by hypothesis over seeds and client counts.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import split_learning_tpu.planner as jplanner
from split_learning_tpu import config as jcfg
from split_learning_tpu.planner import cluster as jcluster
from split_learning_tpu.planner import selection as jselection
from split_learning_tpu.planner import throughput as jthroughput
from split_learning_tpu.run import synthesize_registrations as jregs
from split_learning_tpu.runtime.plan import plan_clusters as jplan
import split_learning_torch.planner as tplanner
from split_learning_torch import config as tcfg
from split_learning_torch.planner import cluster as tcluster
from split_learning_torch.planner import selection as tselection
from split_learning_torch.planner import throughput as tthroughput
from split_learning_torch.run import synthesize_registrations as tregs
from split_learning_torch.runtime.plan import plan_clusters as tplan

SETTINGS = settings(max_examples=25, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def test_planner_exports_the_jax_package_names():
    assert tplanner.__all__ == jplanner.__all__
    for name in tplanner.__all__:
        assert callable(getattr(tplanner, name))


def _label_counts(seed, n, labels=10, alpha=0.3, samples=2500):
    return tplanner.synthesize_label_counts(n, labels, samples, non_iid=True,
                                            alpha=alpha, seed=seed)


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 24),
       k=st.integers(1, 6))
def test_kmeans_labels_equal(seed, n, k):
    counts = _label_counts(seed, n)
    np.testing.assert_array_equal(
        tplanner.synthesize_label_counts(n, 10, 2500, non_iid=True,
                                         alpha=0.3, seed=seed),
        jplanner.synthesize_label_counts(n, 10, 2500, non_iid=True,
                                         alpha=0.3, seed=seed))
    lt, it = tcluster.kmeans_cluster(counts, k, seed=seed % 1000)
    lj, ij = jcluster.kmeans_cluster(counts, k, seed=seed % 1000)
    np.testing.assert_array_equal(lt, lj)
    assert it == ij
    x = np.random.default_rng(seed).standard_normal((n, 3))
    for a, b in zip(tcluster.kmeans(x, min(k, n), seed=seed % 97),
                    jcluster.kmeans(x, min(k, n), seed=seed % 97)):
        np.testing.assert_array_equal(a, b)


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 16))
def test_affinity_propagation_labels_equal(seed, n):
    counts = _label_counts(seed, n)
    np.testing.assert_array_equal(
        tcluster.affinity_propagation(counts.astype(float)),
        jcluster.affinity_propagation(counts.astype(float)))
    for algo in ("KMeans", "k-means", "AffinityPropagation"):
        lt, it = tcluster.clustering_algorithm(counts, 3, algo)
        lj, ij = jcluster.clustering_algorithm(counts, 3, algo)
        np.testing.assert_array_equal(lt, lj)
        assert it == ij


def test_unknown_clustering_algorithm_raises_in_both():
    for mod in (tcluster, jcluster):
        with pytest.raises(ValueError, match="unknown clustering"):
            mod.clustering_algorithm([[1, 2]], 1, "dbscan")


def _speeds(seed, n, slow):
    """``n`` device speeds: most near 100 samples/s, ``slow`` of them
    near 10, with lognormal spread; some all equal when ``n`` is 1."""
    rng = np.random.default_rng(seed)
    fast = 100 * rng.lognormal(0, 0.1, n)
    fast[:min(slow, n)] /= 10
    return rng.permutation(fast)


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 20),
       slow=st.integers(0, 5))
def test_selection_threshold_equal(seed, n, slow):
    speeds = _speeds(seed, n, slow)
    tt = tselection.auto_threshold(speeds)
    tj = jselection.auto_threshold(speeds)
    assert isinstance(tt, float) and tt == tj
    mt, thr_t = tselection.select_devices(speeds)
    mj, thr_j = jselection.select_devices(speeds)
    np.testing.assert_array_equal(mt, mj)
    assert thr_t == thr_j
    off_t = tselection.select_devices(speeds, enabled=False)
    assert off_t[0].all() and off_t[1] == 0.0
    if n >= 2:
        x = np.log(speeds)
        for a, b in zip(tselection._gmm_em_1d(x, seed=seed % 13),
                        jselection._gmm_em_1d(x, seed=seed % 13)):
            np.testing.assert_array_equal(a, b)


def test_selection_clamps_dead_devices_equally():
    speeds = [0.0, -1.0, 95.0, 101.0, 99.0, 12.0]
    assert tselection.auto_threshold(speeds) == \
        jselection.auto_threshold(speeds)


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), n_layers=st.integers(3, 14),
       n_groups=st.integers(1, 4), devices=st.integers(1, 3))
def test_throughput_model_equal(seed, n_layers, n_groups, devices):
    rng = np.random.default_rng(seed)
    exe = [[list(rng.uniform(1e-4, 1e-2, n_layers))
            for _ in range(devices)] for _ in range(n_groups)]
    net = [list(rng.choice([0.0, 1e6, 1e8, 1e9], devices))
           for _ in range(n_groups)]
    size = list(rng.integers(1_000, 10_000_000, n_layers).astype(float))
    cuts = sorted(rng.choice(np.arange(1, n_layers), n_groups - 1,
                             replace=False).tolist()) \
        if n_groups - 1 <= n_layers - 1 else []
    rate = float(rng.uniform(1, 100))
    assert tthroughput.scaled_exe_time(exe[0][0], rate) == \
        jthroughput.scaled_exe_time(exe[0][0], rate)
    assert tthroughput.scaled_exe_time(exe[0][0], None) == exe[0][0]
    for r, c in ((rate, rate * 2), (rate, 0.0), (None, rate)):
        assert tthroughput.implied_bandwidth(size[0], r, c) == \
            jthroughput.implied_bandwidth(size[0], r, c)
    if len(cuts) == n_groups - 1:
        assert tthroughput.stage_rates(exe, net, cuts, size) == \
            jthroughput.stage_rates(exe, net, cuts, size)
        assert tthroughput.predict_round_wall(exe, net, cuts, size, 64) == \
            jthroughput.predict_round_wall(exe, net, cuts, size, 64)
        assert tthroughput.replan_cuts(exe, net, size, cuts, window=4) == \
            jthroughput.replan_cuts(exe, net, size, cuts, window=4)
    assert tplanner.partition_multiway(exe, net, size) == \
        jplanner.partition_multiway(exe, net, size)


BASELINE2 = "configs/baseline2.yaml"


def _assert_plans_equal(tp, jp):
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert (a.cluster_id, a.cuts, a.clients, a.rejected) == \
            (b.cluster_id, b.cuts, b.clients, b.rejected)
        np.testing.assert_array_equal(a.label_counts, b.label_counts)


def _both(d=None, path=None):
    if path is not None:
        return jcfg.from_yaml(path), tcfg.from_yaml(path)
    return jcfg.from_dict(d), tcfg.from_dict(d)


def _regs(jc, tc, profiles=None, clusters=None):
    jr, tr = jregs(jc, profiles), tregs(tc, profiles)
    for regs in (jr, tr):
        for r in regs:
            if clusters and r.client_id in clusters:
                r.cluster = clusters[r.client_id]
    return jr, tr


def test_baseline2_plan_equal():
    """``configs/baseline2.yaml`` as written (2500 samples a client,
    Dirichlet 0.3, KMeans into 2 clusters, selection on, even cut): the
    reference plan, and with one stage-1 client at a tenth of the
    others' speed (selection rejects it) under profiled cuts."""
    jc, tc = _both(path=BASELINE2)
    jr, tr = _regs(jc, tc)
    tp, jp = tplan(tc, tr), jplan(jc, jr)
    _assert_plans_equal(tp, jp)
    assert [p.clients for p in tp] == [
        [["client_1_0", "client_1_1", "client_1_3"], ["client_2_0"]],
        [["client_1_2"], ["client_2_1"]]]
    assert [p.cuts for p in tp] == [[26], [26]]
    assert int(sum(p.label_counts.sum() for p in tp)) == 4 * 2500
    rng = np.random.default_rng(7)
    exe = list(rng.uniform(1e-5, 1e-3, 52))
    size = list(rng.integers(1e3, 1e6, 52).astype(float))
    profiles = {f"client_1_{i}": {
        "exe_time": exe, "size_data": size, "network": 1e9,
        "speed": 1000.0 / (10 if i == 1 else 1) + i}
        for i in range(4)}
    jr, tr = _regs(jc, tc, profiles)
    tp, jp = tplan(tc, tr), jplan(jc, jr)
    _assert_plans_equal(tp, jp)
    assert tp[0].rejected == ["client_1_1"]
    assert "client_1_1" not in tp[0].stage1_clients
    assert tp[0].cuts != [26]


@SETTINGS
@given(seed=st.integers(0, 10_000), n1=st.integers(2, 10),
       n2=st.integers(1, 3), k=st.integers(1, 3),
       slow=st.integers(0, 3), mode=st.sampled_from(["auto", "manual"]))
def test_plan_clusters_equal(seed, n1, n2, k, slow, mode):
    """Random deployments: Dirichlet or IID label counts, auto (KMeans)
    or manual (round-robin and Register.cluster) clusters, selection on
    with some stage-1 clients at a tenth of the speed, profiles with
    per-layer times (auto cuts) or without (even split)."""
    rng = np.random.default_rng(seed)
    d = {"model": "VGG16", "dataset": "CIFAR10", "clients": [n1, n2],
         "seed": seed,
         "topology": {"mode": mode, "num-clusters": k, "selection": True,
                      **({"cut-layers": [7]} if mode == "manual" else {})},
         "distribution": ({"mode": "dirichlet", "alpha": 0.5,
                           "num-samples": 64} if seed % 2 else
                          {"num-samples": 64}),
         "transport": {"wire-dtype": ["float32", "bfloat16"][seed % 2]}}
    jc, tc = _both(d)
    speeds = _speeds(seed, n1, slow)
    with_exe = bool(seed % 3)
    profiles = {f"client_1_{i}": dict(
        {"speed": float(speeds[i])},
        **({"exe_time": list(rng.uniform(1e-5, 1e-3, 52)),
            "size_data": [float(s) for s in rng.integers(1e3, 1e6, 52)],
            "network": float(rng.choice([0.0, 1e8]))}
           if with_exe else {})) for i in range(n1)}
    clusters = ({f"client_1_{i}": int(rng.integers(-1, k + 1))
                 for i in range(n1)} if mode == "manual" else None)
    jr, tr = _regs(jc, tc, profiles, clusters)
    _assert_plans_equal(tplan(tc, tr), jplan(jc, jr))


def test_fixed_distribution_and_manual_cluster_cuts_equal():
    d = {"model": "VGG16", "dataset": "CIFAR10", "clients": [3, 2],
         "topology": {"num-clusters": 2, "cluster-cut-layers": [[7], [13]]},
         "distribution": {"mode": "fixed", "matrix": [
             [5, 0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 5, 5, 0, 0, 0, 0, 0, 0, 0],
             [1, 1, 1, 1, 1, 1, 1, 1, 1, 1]]}}
    jc, tc = _both(d)
    jr, tr = _regs(jc, tc, clusters={"client_1_0": 1, "client_2_1": 0})
    tp = tplan(tc, tr)
    _assert_plans_equal(tp, jplan(jc, jr))
    assert [p.cuts for p in tp] == [[7], [13]]


def test_require_profiles_refuses_in_both():
    d = {"model": "VGG16", "dataset": "CIFAR10", "clients": [2, 1],
         "topology": {"mode": "auto", "require-profiles": True}}
    jc, tc = _both(d)
    jr, tr = _regs(jc, tc)
    for plan, cfg, regs in ((tplan, tc, tr), (jplan, jc, jr)):
        with pytest.raises(ValueError, match="require_profiles"):
            plan(cfg, regs)


def test_plan_dataclass_fields_match():
    from split_learning_tpu.runtime.plan import ClusterPlan as J
    from split_learning_torch.runtime.plan import ClusterPlan as T
    assert [f.name for f in dataclasses.fields(T)] == \
        [f.name for f in dataclasses.fields(J)]
