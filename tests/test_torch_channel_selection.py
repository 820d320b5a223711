"""The port's channel selection held against the JAX package and SciPy.

ANOVA (the incomplete beta of ``ops/anova.py`` in torch), the run-length
op, the ``active`` and ``discriminative`` plugins and the stage entry run
through both packages on the same seeded numpy inputs.

Tolerance on p against JAX, looser than the JAX oracle tests' atol 1e-4
against SciPy (``tests/test_ops_stats.py``), and why: both packages form
``x = dfd / (dfd + dfn*F)`` in float32, and where F is ~1e-4 that ``x``
rounds to ~1 - 5e-7, which moves p near 1 by ~3e-3 from SciPy in either
package; the two packages' float32 F differ in their last bits (different
summation orders), so near p = 1 their p differ by up to ~6e-4. The atol
1e-4 of the oracle tests holds only on their data. So p is held within
rtol 1e-4 of JAX's where p < 1e-3 (where thresholds are drawn) and within
atol 1e-3 elsewhere; the selected channels and run lengths, which are what
the stage writes, are held equal.

Below p = 1e-3 a float32 F error is multiplied by about dfd/2 in p. At
240 rest against 60 event trials (dfd 298) both packages lie within ~3e-5
of SciPy; at 240 against 300 (dfd 538) JAX's own float32 F puts its p
~1.1e-4 from SciPy's, the port's ~4e-5. So the rtol 1e-4 against JAX is
checked at the former size, and the port is held within rtol 1e-4 of
SciPy's float64 p at both.
"""

import json
import os

import numpy as np
import pytest
import scipy.stats as st
import torch

from decode_tonal_langauge_tpu.channel_selection import active as jactive
from decode_tonal_langauge_tpu.channel_selection import discriminative as jdisc
from decode_tonal_langauge_tpu.channel_selection import main as jmain
from decode_tonal_langauge_tpu.channel_selection import utils as jutils
from decode_tonal_langauge_tpu.ops import anova as janova
from decode_tonal_langauge_tpu.ops.runlength import max_consecutive_true as jrun
from decode_tonal_langauge_tpu_torch import registry
from decode_tonal_langauge_tpu_torch.channel_selection import active, discriminative
from decode_tonal_langauge_tpu_torch.channel_selection import main as cs_main
from decode_tonal_langauge_tpu_torch.channel_selection import utils
from decode_tonal_langauge_tpu_torch.ops import anova
from decode_tonal_langauge_tpu_torch.ops.runlength import max_consecutive_true

C, T, SF = 128, 200, 400.0
PLANTED_ACTIVE = range(0, 16)


# Near float32's underflow (smallest normal ~1.2e-38) p carries no
# relative precision: JAX's float32 fraction gives ~2e-38 where the
# port's float64 one rounds to 0. Below P_FLOOR, far below any threshold,
# both must only stay below it.
P_FLOOR = 1e-30


def assert_p_close(got, want):
    small = (want < 1e-3) & (want >= P_FLOOR)
    np.testing.assert_allclose(got[small], want[small], rtol=1e-4, atol=0)
    assert (got[want < P_FLOOR] < P_FLOOR).all()
    np.testing.assert_allclose(got[~small], want[~small], rtol=0, atol=1e-3)


def _sample(n_groups=4, seed=0, n=60, n_rest=240):
    """``n`` seeded trials of C x T: channels 0-15 active against rest
    in samples 40-160, channels 20-29 separate one label value in samples
    60-160 and channels 40-44 another in 20-80; ``n_rest`` rest trials."""
    rng = np.random.default_rng(seed)
    ecog = rng.standard_normal((n, C, T)).astype(np.float32)
    rest = rng.standard_normal((n_rest, C, T)).astype(np.float32)
    labels = rng.integers(0, n_groups, n)
    ecog[:, :16, 40:160] += 0.8
    ecog[labels == 1, 20:30, 60:160] += 1.5
    ecog[labels == n_groups - 1, 40:45, 20:80] -= 1.5
    return {"ecog": ecog, "ecog_rest": rest, "ecog_sf": np.float64(SF),
            "tone": labels, "syllable": (labels % 2)}


@pytest.mark.parametrize("dfn,dfd", [(1, 298), (3, 316), (7, 88), (1, 20), (2, 5)])
def test_f_sf_matches_scipy(dfn, dfd):
    rng = np.random.default_rng(dfd)
    f = np.concatenate([rng.gamma(1.0, 2.0, 500), [0.0, 1e-6, 1e-4, 50.0, 200.0]])
    got = anova.f_sf(torch.tensor(f), dfn, dfd).numpy()
    np.testing.assert_allclose(got, st.f.sf(f, dfn, dfd), rtol=1e-9, atol=1e-12)


def test_betainc_matches_scipy():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0.2, 200, 400), rng.uniform(0.2, 200, 400)
    x = rng.uniform(0, 1, 400)
    got = anova.betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x)).numpy()
    import scipy.special as sps

    np.testing.assert_allclose(got, sps.betainc(a, b, x), rtol=1e-8, atol=1e-12)


def assert_p_near_scipy(got, ref):
    """Below p = 1e-3 only: near p = 1 both packages' float32 ``x`` puts
    p up to ~3e-3 from SciPy (module docstring)."""
    small = (ref < 1e-3) & (ref >= P_FLOOR)
    assert small.sum() > 100
    np.testing.assert_allclose(got[small], ref[small], rtol=1e-4, atol=0)
    assert (got[ref < P_FLOOR] < P_FLOOR).all()


def test_two_group_anova_matches_jax_and_scipy():
    s = _sample()
    f, p = anova.f_oneway_two_groups(torch.tensor(s["ecog_rest"]), torch.tensor(s["ecog"]))
    jf, jp = janova.f_oneway_two_groups(s["ecog_rest"], s["ecog"])
    assert f.dtype == p.dtype == torch.float32 and p.shape == (C, T)
    assert_p_close(p.numpy(), np.asarray(jp))
    ref = st.f_oneway(s["ecog_rest"].astype(np.float64), s["ecog"].astype(np.float64))
    assert_p_near_scipy(p.numpy(), ref.pvalue)
    big = _sample(n=300)
    _, p = anova.f_oneway_two_groups(torch.tensor(big["ecog_rest"]), torch.tensor(big["ecog"]))
    ref = st.f_oneway(big["ecog_rest"].astype(np.float64), big["ecog"].astype(np.float64))
    assert_p_near_scipy(p.numpy(), ref.pvalue)


@pytest.mark.parametrize("n_groups", [2, 4, 8])
def test_labeled_anova_matches_jax_and_scipy(n_groups):
    s = _sample(n_groups, seed=n_groups, n=300)
    x, labels = s["ecog"], s["tone"]
    f, p = anova.f_oneway_labeled(torch.tensor(x), labels, n_groups)
    jf, jp = janova.f_oneway_labeled(x, labels, n_groups)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-5)
    assert_p_close(p.numpy(), np.asarray(jp))
    ref = st.f_oneway(*[x[labels == g].astype(np.float64) for g in range(n_groups)])
    assert_p_near_scipy(p.numpy(), ref.pvalue)


def test_labeled_anova_skips_empty_groups_and_checks_labels():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 4, 6)).astype(np.float32)
    labels = np.repeat([0, 2, 3], 10)  # group 1 is empty: k = 3
    f, p = anova.f_oneway_labeled(torch.tensor(x), labels, 4)
    ref = st.f_oneway(*[x[labels == g] for g in (0, 2, 3)])
    np.testing.assert_allclose(f.numpy(), ref.statistic, rtol=1e-4)
    np.testing.assert_allclose(p.numpy(), ref.pvalue, atol=1e-6)
    with pytest.raises(ValueError, match="labels"):
        anova.f_oneway_labeled(torch.tensor(x), labels, 3)


@pytest.mark.parametrize("case", ["random", "all_false", "all_true", "edges"])
def test_max_consecutive_true_equals_jax(case):
    rng = np.random.default_rng(0)
    mask = {
        "random": rng.random((16, 200)) < 0.7,
        "all_false": np.zeros((3, 17), bool),
        "all_true": np.ones((3, 17), bool),
        "edges": np.array([[1, 1, 0, 1, 1, 1], [0, 0, 0, 0, 0, 1], [1, 0, 0, 0, 0, 0]], bool),
    }[case]
    got = max_consecutive_true(mask)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrun(mask)))


def test_get_max_length_and_find_significant_channels_equal_jax():
    for idx in ([], [3], [0, 1, 2, 5, 6], [2, 3, 4, 10, 11, 12, 13]):
        idx = np.asarray(idx, dtype=int)
        assert utils.get_max_length(idx) == jutils.get_max_length(idx)
    rng = np.random.default_rng(2)
    p = rng.random((12, 50)) * 1e-3
    p[:, ::7] = 0.5
    for length in (0, 3, 6):
        assert utils.find_significant_channels(p, 0.05, length) == \
            jutils.find_significant_channels(p, 0.05, length)


def test_active_run_equals_jax():
    s = _sample()
    params = {"p_threshold": 0.05, "active_time_threshold": 0.05,
              "rest_name": "ecog_rest", "erp_name": "ecog"}
    got = active.run(s, params, device="cpu")
    want = jactive.run(s, params)
    assert got["selected_channels"] == want["selected_channels"]
    assert got["max_lengths"] == want["max_lengths"]
    assert set(PLANTED_ACTIVE) <= set(got["selected_channels"])
    assert got["p_values"].shape == (C, T)
    assert_p_close(got["p_values"], np.asarray(want["p_values"]))


@pytest.mark.parametrize("n_groups,key", [(4, "label"), (8, "target"), (2, "label")])
def test_discriminative_run_equals_jax(n_groups, key):
    s = _sample(n_groups, seed=10 + n_groups, n=300)
    params = {"p_threshold": 0.05, "active_time_threshold": 0.05, key: "tone",
              "recording_name": "ecog"}
    got = discriminative.run(s, params, device="cpu")
    want = jdisc.run(s, params)
    assert got["selected_channels"] == want["selected_channels"]
    assert got["max_lengths"] == want["max_lengths"]
    assert set(range(20, 30)) <= set(got["selected_channels"])
    assert_p_close(got["p_values"], np.asarray(want["p_values"]))
    power = discriminative.test_discriminative_power(s, params, device="cpu")
    jpower = jdisc.test_discriminative_power(s, params)
    np.testing.assert_allclose(power["f_stat"], jpower["f_stat"], rtol=1e-4, atol=1e-5)


def test_string_labels_map_to_dense_codes():
    s = _sample(2, seed=4, n=300)
    s["syllable"] = np.where(s["tone"] == 1, "ma", "mi")
    params = {"p_threshold": 0.05, "active_time_threshold": 0.05, "target": "syllable"}
    got = discriminative.run(s, params, device="cpu")
    assert got["selected_channels"] == jdisc.run(s, params)["selected_channels"]


@pytest.mark.parametrize("case", [
    "no_key", "no_sf", "no_recording", "not_3d", "no_labels", "labels_2d",
    "labels_count", "active_no_sf", "active_no_rest", "active_shape",
])
def test_error_paths_match_jax(case):
    s = _sample(2, seed=5, n=20, n_rest=10)
    params = {"p_threshold": 0.05, "active_time_threshold": 0.05, "label": "tone"}
    act = {"p_threshold": 0.05, "active_time_threshold": 0.05}
    plugin, jplugin = discriminative.run, jdisc.run
    if case == "no_key":
        params = {"active_time_threshold": 0.05}
    elif case == "no_sf":
        s.pop("ecog_sf")
    elif case == "no_recording":
        params["recording_name"] = "hg"
        s["hg_sf"] = SF
    elif case == "not_3d":
        s["ecog"] = s["ecog"][:, 0]
    elif case == "no_labels":
        params["label"] = "vowel"
    elif case == "labels_2d":
        s["tone"] = np.stack([s["tone"], s["tone"]], axis=1)
    elif case == "labels_count":
        s["tone"] = s["tone"][:-1]
    else:
        plugin, jplugin, params = active.run, jactive.run, act
        if case == "active_no_sf":
            s.pop("ecog_sf")
        elif case == "active_no_rest":
            s.pop("ecog_rest")
        else:
            s["ecog_rest"] = s["ecog_rest"][:, :5]
    with pytest.raises(Exception) as want:
        jplugin(s, params)
    with pytest.raises(want.type) as got:
        plugin(s, params, device="cpu")
    assert str(got.value) == str(want.value)


def _stage_config(sample_dir, out_dir):
    sel = [
        {"module": "channel_selection.active", "selection_name": "active_channels",
         "params": {"p_threshold": 0.05, "active_time_threshold": 0.05,
                    "rest_name": "ecog_rest", "erp_name": "ecog"}},
        {"module": "channel_selection.discriminative",
         "selection_name": "tone_discriminative",
         "params": {"p_threshold": 0.05, "active_time_threshold": 0.05,
                    "label": "tone", "recording_name": "ecog"}},
        {"module": "discriminative", "selection_name": "syllable_discriminative",
         "params": {"p_threshold": 0.05, "active_time_threshold": 0.05,
                    "target": "syllable"}},
    ]
    return {"channel_selection": {"module": "channel_selection_main", "params": {
        "io": {"sample_dir": str(sample_dir), "output_dir": str(out_dir), "figures": False},
        "selections": sel}}}


def test_stage_json_and_provenance_equal_jax(tmp_path):
    from decode_tonal_langauge_tpu_torch.config import load_config

    samples = tmp_path / "samples__abc123"
    samples.mkdir()
    np.savez(samples / "subject_1.npz", **_sample(4, seed=7, n=300))
    (samples / "config.yaml").write_text("sample_collection: {module: extract_samples}\n")
    # one output dir (it is part of the hashed config), JAX's moved aside
    want = jmain.run(_stage_config(samples, tmp_path / "out"))
    with open(os.path.join(want, "subject_1.json")) as f:
        want_sel = json.load(f)
    want_cfg = load_config(os.path.join(want, "config.yaml"))
    os.rename(tmp_path / "out", tmp_path / "jax")
    got = cs_main.run(_stage_config(samples, tmp_path / "out"), device="cpu")
    assert got == want
    with open(os.path.join(got, "subject_1.json")) as f:
        sel = json.load(f)
    assert sel == want_sel
    assert set(PLANTED_ACTIVE) <= set(sel["active_channels"])
    assert set(range(20, 30)) <= set(sel["tone_discriminative"])
    assert load_config(os.path.join(got, "config.yaml")) == want_cfg


def test_stage_cli_and_user_plugin(tmp_path, monkeypatch):
    """A user plugin gets (data, params) only; the CLI runs with
    ``--device cpu``; an empty selection warns."""
    import sys
    import types

    import yaml

    calls = []
    plugin = types.ModuleType("user_cs_plugin")
    plugin.run = lambda data, params: calls.append(sorted(params)) or {
        "selected_channels": []}
    monkeypatch.setitem(sys.modules, "user_cs_plugin", plugin)
    samples = tmp_path / "samples"
    samples.mkdir()
    np.savez(samples / "subject_3.npz", **_sample(2, seed=8, n=40, n_rest=20))
    cfg = _stage_config(samples, tmp_path / "out")
    cfg["channel_selection"]["params"]["selections"].append(
        {"module": "user_cs_plugin", "selection_name": "mine", "params": {"k": 1}})
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.warns(UserWarning, match="mine"):
        out = cs_main.main([str(path), "--device", "cpu"])
    assert calls == [["k"]]
    with open(os.path.join(out, "subject_3.json")) as f:
        assert json.load(f)["mine"] == []
    assert registry.resolve("active") is active
    assert registry.resolve("channel_selection_main") is cs_main


def test_stage_figures_where_matplotlib_imports(tmp_path):
    samples = tmp_path / "samples"
    samples.mkdir()
    np.savez(samples / "subject_2.npz", **_sample(2, seed=9, n=300))
    cfg = _stage_config(samples, tmp_path / "out")
    cfg["channel_selection"]["params"]["io"]["figures"] = True
    out = cs_main.run(cfg, device="cpu")
    figures = os.path.join(out, "figures")
    active_dir = os.path.join(figures, "active_channels", "subject_2")
    assert "active_lengths.png" in os.listdir(active_dir)
    assert len(os.listdir(active_dir)) == 11  # the histogram + 10 sampled channels
    tone = os.listdir(os.path.join(figures, "tone_discriminative", "subject_2"))
    assert tone and all(f.startswith("tone_channel_") for f in tone)
