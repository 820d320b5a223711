"""The port's quality-parity harness (``scripts/measure_parity_torch.py``)
against the JAX package's (``scripts/measure_parity.py``), imported as
modules, on the CPU at a reduced size.

- A reduced synthetic subject (16 channels, 2 blocks x 16 trials, the
  harness's tone channels 0-5 and syllable channels 6-11) written by both
  packages: byte-equal raw blocks and TextGrids.
- Both harnesses' pipeline stages on it: the sample npz's keys, shapes
  and labels equal, its epochs within the preprocess stage's rtol/atol
  1e-3 (``tests/test_torch_pipeline.py``'s rule), the channel-selection
  JSON equal.
- Both harnesses' ``cnn`` cell at 2 seeds x 2 epochs on those outputs:
  the same seed list (``np.random.seed(42)``'s draw), the same split
  indices for every seed, and results JSONs with the same keys and shapes
  (the port adds only its comparison, meta and pipeline wall, and each
  cell's seeds and epochs). The port's cell trains the paper CNN; the
  JAX harness's cell goes through its ``main`` and ``train_ours`` with the
  logistic model in the CNN's place, since XLA's CPU convolutions take
  ~4 minutes for the CNN's and the keys and shapes a harness records do
  not depend on the model.
- ``compare_cell`` on hand-built cells: a saturated cell, a bimodal one
  (PARITY.json's hard-subject CNN), a shifted mean, a collapsed escape
  count and synthesis deltas on each side of their bands; its Fisher test
  against SciPy's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu.data.splits import split_indices as jsplit
from decode_tonal_langauge_tpu.data.synthetic import SyntheticSpec as JSpec
from decode_tonal_langauge_tpu.data.synthetic import write_subject as jwrite_subject
from decode_tonal_langauge_tpu.utils.seeding import seed_stream as jseed_stream
from decode_tonal_langauge_tpu_torch.data.splits import split_indices
from decode_tonal_langauge_tpu_torch.data.synthetic import SyntheticSpec, write_subject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port = _load("measure_parity_torch")
jax_harness = _load("measure_parity")

# The harness's subject (build_subject) cut to 16 channels, 2 x 16 trials.
REDUCED = dict(n_channels=16, n_blocks=2, trials_per_block=16, ecog_sf=1000.0,
               audio_sf=8000.0, active_channels=tuple(range(16)),
               tone_channels=(0, 1, 2, 3, 4, 5), syllable_channels=(6, 7, 8, 9, 10, 11))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test, as in ``tests/test_torch_bf16.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both harnesses over the reduced subject: raw files, pipeline
    outputs, and a CNN cell at 2 seeds x 2 epochs (``results``)."""
    torch.set_num_threads(1)
    out = {}
    for name, writer, spec in (("port", write_subject, SyntheticSpec),
                               ("jax", jwrite_subject, JSpec)):
        workdir = str(tmp_path_factory.mktemp(name))
        writer(os.path.join(workdir, "raw"), 1, spec(**REDUCED))
        out[name] = {"workdir": workdir}
    out["port"]["outputs"] = port.run_pipeline_stages(out["port"]["workdir"], "cpu")
    out["jax"]["outputs"] = jax_harness.run_pipeline_stages(out["jax"]["workdir"])

    for name in ("port", "jax"):  # the harnesses resume from the pipeline's state
        with open(os.path.join(out[name]["workdir"], "parity_state.json"), "w") as f:
            json.dump({"outputs": out[name]["outputs"], "noise_scale": 1.0}, f)
    port.main(["--workdir", out["port"]["workdir"], "--only", "cnn", "--seeds", "2",
               "--epochs", "2", "--device", "cpu"])
    # The JAX harness refuses --seeds below 3 (its torch cells' prefix),
    # which this harness does not have: set its seed count directly.
    n_seeds, train_ours = jax_harness.N_OUR_SEEDS, jax_harness.train_ours
    jax_harness.N_OUR_SEEDS = 2
    jax_harness.train_ours = lambda workdir, outputs, model_path, *a, **k: train_ours(
        workdir, outputs, "models.simple_classifiers.LogisticRegressionClassifier", *a, **k)
    try:
        argv = ["measure_parity.py", "--workdir", out["jax"]["workdir"], "--only", "cnn",
                "--epochs", "2"]
        old_argv, jax_harness.sys.argv = jax_harness.sys.argv, argv
        try:
            jax_harness.main()
        finally:
            jax_harness.sys.argv = old_argv
    finally:
        jax_harness.N_OUR_SEEDS, jax_harness.train_ours = n_seeds, train_ours
        jax_harness.EPOCHS = 30
    for name in ("port", "jax"):
        with open(os.path.join(out[name]["workdir"], "parity_results.json")) as f:
            out[name]["results"] = json.load(f)
    return out


def test_subject_raw_files_equal(runs):
    proot, jroot = (os.path.join(runs[k]["workdir"], "raw") for k in ("port", "jax"))
    files = _files(proot)
    assert files == _files(jroot) and len(files) == 4  # 2 blocks + 2 TextGrids
    for rel in files:
        with open(os.path.join(proot, rel), "rb") as a, open(os.path.join(jroot, rel),
                                                             "rb") as b:
            assert a.read() == b.read(), rel


def test_pipeline_outputs_agree(runs):
    got, want = (np.load(os.path.join(runs[k]["outputs"]["sample_collection"],
                                      "subject_1.npz")) for k in ("port", "jax"))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape, key
        if np.issubdtype(want[key].dtype, np.floating):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-3,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    sel = [json.load(open(os.path.join(runs[k]["outputs"]["channel_selection"],
                                       "subject_1.json"))) for k in ("port", "jax")]
    assert sel[0] == sel[1]
    assert set(sel[0]["syllable_discriminative"]) & set(range(6, 12))


def test_seeds_and_splits_equal(runs):
    cell = runs["port"]["results"]["cnn"]
    np.random.seed(42)  # the JAX harness's stream for its torch cells
    harness_stream = np.random.randint(0, 10000, 2).tolist()
    assert cell["seeds"] == jseed_stream(42, 2).tolist() == harness_stream
    n = np.load(os.path.join(runs["port"]["outputs"]["sample_collection"],
                             "subject_1.npz"))["ecog"].shape[0]
    for seed in cell["seeds"]:
        for g, w in zip(split_indices(n, [0.7, 0.1, 0.2], seed),
                        jsplit(n, [0.7, 0.1, 0.2], seed)):
            np.testing.assert_array_equal(g, w)


def test_results_json_keys_and_shapes(runs):
    got, want = runs["port"]["results"], runs["jax"]["results"]
    # the pipeline ran before the harnesses (the fixture), so no pipeline wall
    assert set(got) - set(want) == {"comparison", "meta"}
    assert set(want) <= set(got)
    assert set(got["outputs"]) == set(want["outputs"])
    assert set(got["cnn"]) - set(want["cnn"]) == {"seeds", "epochs"}
    for key, value in want["cnn"].items():
        assert type(got["cnn"][key]) is type(value), key
    assert len(got["cnn"]["accuracy_all"]) == len(want["cnn"]["accuracy_all"]) == 2
    assert all(0.0 <= a <= 1.0 for a in got["cnn"]["accuracy_all"])
    cmp = got["comparison"]["cnn"]
    assert cmp["kind"] == "accuracy" and cmp["saturated"] and cmp["port"]["n"] == 2
    assert cmp["jax"]["n"] == 48 and cmp["verdict"] in ("within", "outside")
    assert got["meta"]["device"] == "cpu" and got["meta"]["card"] is None


def test_compare_cell_rules():
    with open(os.path.join(REPO, "PARITY.json")) as f:
        hard = json.load(f)["hard_subject"]["cnn"]["accuracy_all"]
    saturated = {"accuracy_all": [1.0] * 48}
    ok = port.compare_cell({"accuracy_all": [1.0, 1.0, 0.96875]}, saturated)
    assert ok["saturated"] and ok["verdict"] == "within"
    bad = port.compare_cell({"accuracy_all": [1.0, 0.9375]}, saturated)
    assert bad["verdict"] == "outside" and "saturated" in bad["reasons"][0]

    jax = {"accuracy_all": hard}
    same = port.compare_cell({"accuracy_all": hard[::-1]}, jax)
    assert same["verdict"] == "within" and same["mean_diff"] == pytest.approx(0)
    assert same["escape_fisher_p"] == pytest.approx(1.0)
    assert same["jax"]["escapes"] == 16 and same["jax"]["n"] == 48
    shifted = port.compare_cell({"accuracy_all": [min(1.0, a + 0.2) for a in hard]}, jax)
    assert shifted["verdict"] == "outside"
    assert any("mean diff" in r for r in shifted["reasons"])
    collapsed = [0.5] * 40 + [0.72] * 2 + [0.45] * 6  # 2 escapes of 48, mean ~0.52
    escapes = port.compare_cell({"accuracy_all": collapsed}, jax)
    assert any("Fisher" in r for r in escapes["reasons"])

    synth = {"mcd_mean": 600.0, "mel_pearson_r_mean": 0.93}
    for mcd, r, verdict in ((650.0, 0.92, "within"), (545.0, 0.949, "within"),
                            (600.0, 0.905, "outside"), (661.0, 0.93, "outside")):
        cmp = port.compare_cell({"mcd_mean": mcd, "mel_pearson_r_mean": r}, synth)
        assert cmp["kind"] == "synthesis" and cmp["verdict"] == verdict, (mcd, r)


@pytest.mark.parametrize("table", [(16, 32, 18, 30), (2, 46, 16, 32), (0, 12, 5, 7),
                                   (3, 1, 1, 3)])
def test_fisher_exact_equals_scipy(table):
    from scipy.stats import fisher_exact

    want = fisher_exact([table[:2], table[2:]], alternative="two-sided").pvalue
    assert port._fisher_two_sided(*table) == pytest.approx(want, rel=1e-9)
