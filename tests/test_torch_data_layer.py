"""The port's epoch-extraction data layer against the JAX package's.

Host numpy on both sides, so every output is held exactly: TextGrid text
and parses, interval records against the DataFrame rows, the sample npz
arrays (dtypes included) and syllable codes, the stage's output directory
name and npz, the unlabelled patches and the synthetic subjects, byte for
byte. The cases are those of ``tests/test_data_layer.py``.
"""

import dataclasses
import os
import warnings

import numpy as np
import pandas as pd
import pytest

from decode_tonal_langauge_tpu import config as jconfig
from decode_tonal_langauge_tpu.data import extract_samples as jextract
from decode_tonal_langauge_tpu.data import synthetic as jsynthetic
from decode_tonal_langauge_tpu.data import text_align as jalign
from decode_tonal_langauge_tpu.data import textgrid as jtextgrid
from decode_tonal_langauge_tpu.data import unlabelled as junlabelled
from decode_tonal_langauge_tpu.data import utils as jutils
from decode_tonal_langauge_tpu.preprocess.io import npz_blocks as jnpz
from decode_tonal_langauge_tpu_torch import config, registry
from decode_tonal_langauge_tpu_torch.data import extract_samples, synthetic, text_align
from decode_tonal_langauge_tpu_torch.data import textgrid, unlabelled, utils


def _grid(mod, tiers):
    return mod.TextGrid(0.0, 10.0, [
        mod.IntervalTier(name, 0.0, 10.0, [mod.Interval(*iv) for iv in ivs])
        for name, ivs in tiers])


_TIERS = [("success", [(0.0, 1.0, ""), (1.0, 1.4, "1i"), (1.4, 3.0, ""), (3.0, 3.4, "4a"),
                       (3.4, 5.0, "note"), (5.0, 5.4, "2a"), (5.4, 6.0, "3u")]),
          ("Other", [(0.0, 2.2, "2i"), (2.2, 7.5, "1a")])]


@pytest.fixture
def tg_dir(tmp_path):
    """Two blocks' TextGrids written by the JAX writer, plus a file that
    is not a TextGrid."""
    jtextgrid.write_textgrid(_grid(jtextgrid, _TIERS), str(tmp_path / "HS1_B1.TextGrid"))
    jtextgrid.write_textgrid(_grid(jtextgrid, _TIERS[:1]), str(tmp_path / "B3.TextGrid"))
    (tmp_path / "notes.txt").write_text("not a grid")
    return tmp_path


def test_textgrid_write_and_parse_equal_jax(tmp_path):
    jtextgrid.write_textgrid(_grid(jtextgrid, _TIERS), str(tmp_path / "j.TextGrid"))
    textgrid.write_textgrid(_grid(textgrid, _TIERS), str(tmp_path / "t.TextGrid"))
    assert (tmp_path / "j.TextGrid").read_bytes() == (tmp_path / "t.TextGrid").read_bytes()
    got = textgrid.TextGrid.from_file(str(tmp_path / "j.TextGrid"))
    want = jtextgrid.TextGrid.fromFile(str(tmp_path / "j.TextGrid"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.tiers[0].intervals[1] == textgrid.Interval(1.0, 1.4, "1i")
    with pytest.raises(ValueError, match="ooTextFile"):
        textgrid.parse_textgrid("xmin = 0\n")


@pytest.mark.parametrize("kwargs", [
    {}, {"start_offset": 0.2}, {"start_offset": 0.1, "end_offset": 0.3},
    {"tier_list": ["OTHER"]}, {"blocks": [3]}, {"blocks": [7]},
])
def test_handle_textgrids_records_equal_dataframe_rows(tg_dir, kwargs, capsys):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = text_align.handle_textgrids(str(tg_dir), **kwargs)
    got_out = capsys.readouterr().out
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jalign.handle_textgrids(str(tg_dir), **kwargs)
    assert got_out == capsys.readouterr().out
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert list(got) == list(want)
    for block in want:
        assert got[block] == want[block].to_dict("records")


def test_read_textgrid_overlap_and_duration_equal_jax(tmp_path):
    tiers = [("success", [(1.0, 2.0, "1i"), (2.1, 3.0, "2a"), (3.5, 4.0, "3i")])]
    grid = _grid(textgrid, tiers)
    with pytest.warns(UserWarning, match="Overlapping"):
        got = text_align.read_textgrid(grid, 0.0, 0.5)
    with pytest.warns(UserWarning, match="Overlapping"):
        want = jalign.read_textgrid(_grid(jtextgrid, tiers), 0.0, 0.5)
    assert got == want.to_dict("records") and len(got) == 2
    for tiers_wanted in (None, ["success"], ["nonexistent"]):
        assert text_align.get_textgrid_time(grid, tiers_wanted) == \
            jalign.get_textgrid_time(_grid(jtextgrid, tiers), tiers_wanted)


def _recording(rec_dir, sf=100.0, n=3000, dtype=np.float32):
    os.makedirs(rec_dir, exist_ok=True)
    t = np.arange(n)
    for block, scale in ((1, 1.0), (2, -2.0)):
        ecog = (np.stack([t, -t, t % 7]) * scale).astype(dtype)
        np.savez(os.path.join(rec_dir, f"B{block}_ecog.npz"), data=ecog, sf=sf)
        np.savez(os.path.join(rec_dir, f"B{block}_audio.npz"),
                 data=(t[None, :] * scale).astype(dtype), sf=2 * sf)
    np.savez(os.path.join(rec_dir, "B1_sound_extra.npz"), data=np.zeros((1, n)), sf=sf)
    return t


_RECORDS = {
    1: [{"start": 10.0, "end": 10.4, "syllable": "i", "tone": 2},
        {"start": 12.0, "end": 12.4, "syllable": "a", "tone": 4},
        {"start": 13.5, "end": 13.9, "syllable": "x", "tone": 3}],  # x: not a syllable
    2: [{"start": 5.0, "end": 5.4, "syllable": "a", "tone": 2}],
}


@pytest.mark.parametrize("rest,dtype", [
    (None, np.float32), ((0.0, 7.0), np.float32), ((1.0, 20.0), np.float64),
])
def test_extract_ecog_audio_equals_jax(tmp_path, rest, dtype):
    """Arrays, dtypes and codes (-1 for the unknown syllable) exactly equal,
    with a rest period that is cut short by the first event."""
    _recording(str(tmp_path / "rec"), dtype=dtype)
    kwargs = dict(syllables=["i", "a"], length=1.0, rest_period=rest)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = text_align.extract_ecog_audio(
            _RECORDS, str(tmp_path / "rec"), output_path=str(tmp_path / "t.npz"),
            device="cpu", **kwargs)
        want = jalign.extract_ecog_audio(
            {b: pd.DataFrame(r) for b, r in _RECORDS.items()}, str(tmp_path / "rec"),
            output_path=str(tmp_path / "j.npz"), **kwargs)
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["syllable"], [0, 1, -1, 1])
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert t.files == j.files
    for key in j.files:
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_categorical_codes_equal_pandas():
    values = ["b", "a", "zz", "c", "a"]
    for categories in (["a", "b", "c"], [str(i) for i in range(200)] + ["a"]):
        want = pd.Categorical(values, categories=categories).codes
        got = text_align.categorical_codes(values, categories)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _stage_config(tmp_path, raw_root, rec_dir, **subject):
    return {"sample_collection": {"module": "extract_samples", "params": {
        "io": {"output_dir": str(tmp_path / "samples"), "textgrid_root": raw_root,
               "recording_dir": rec_dir, "figures": False},
        "subjects": {1: {"start_offset": 0.2, "sample_length": 1.0,
                         "rest_period": [0.0, 5.0], "textgrid_dir": "annotations/subject_1",
                         "tier_list": ["success"], **subject}},
        "settings": {"syllable_identifiers": ["i", "a"]},
    }}}


def test_extract_samples_stage_equals_jax(tmp_path):
    spec = jsynthetic.SyntheticSpec(n_channels=6, n_blocks=2, trials_per_block=8,
                                    ecog_sf=500.0, audio_sf=1000.0)
    raw_root = str(tmp_path / "raw")
    jsynthetic.write_subject(raw_root, 1, spec)
    rec_dir = str(tmp_path / "processed")
    os.makedirs(os.path.join(rec_dir, "subject_1"))
    for block in (1, 2):  # the preprocess stage's block files, from the raw blocks
        jnpz.save_block(rec_dir, 1, block,
                        jnpz.load_block(os.path.join(raw_root, "Sub1", f"HS1-B{block}")))
    with open(os.path.join(rec_dir, "config.yaml"), "w") as f:
        f.write("preprocess: {module: preprocess_main}\n")

    cfg = _stage_config(tmp_path, raw_root, rec_dir)
    want_dir = jextract.run(cfg)
    os.rename(tmp_path / "samples", tmp_path / "jax_samples")
    got_dir = extract_samples.run(cfg, device="cpu")
    assert got_dir == want_dir
    want_dir = os.path.join(tmp_path, "jax_samples", os.path.basename(want_dir))
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    t, j = (np.load(os.path.join(d, "subject_1.npz")) for d in (got_dir, want_dir))
    assert t.files == j.files
    for key in j.files:
        assert t[key].dtype == j[key].dtype, key
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert config.load_config(os.path.join(got_dir, "config.yaml")) == \
        jconfig.load_config(os.path.join(want_dir, "config.yaml"))

    # a cached subject is kept; another setting hashes to another directory
    mtime = os.path.getmtime(os.path.join(got_dir, "subject_1.npz"))
    assert extract_samples.run(cfg, device="cpu") == got_dir
    assert os.path.getmtime(os.path.join(got_dir, "subject_1.npz")) == mtime
    other = _stage_config(tmp_path, raw_root, rec_dir, sample_length=0.5)
    assert extract_samples._generate_output_dir_name("b", other["sample_collection"]) == \
        jextract._generate_output_dir_name("b", other["sample_collection"])
    assert extract_samples.run(other, device="cpu") != got_dir
    assert registry.resolve("extract_samples") is extract_samples


def test_update_configuration_equals_jax(tmp_path):
    prev = tmp_path / "prev.yaml"
    prev.write_text("preprocess: {a: 1}\nsample_collection: {old: true}\n")
    for src in (str(prev), str(tmp_path / "missing.yaml")):
        config.update_configuration(str(tmp_path / "t.yaml"), src, "sample_collection",
                                    {"params": {"x": [1, 2]}})
        jconfig.update_configuration(str(tmp_path / "j.yaml"), src, "sample_collection",
                                     {"params": {"x": [1, 2]}})
        assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()


@pytest.mark.parametrize("seg,patch,step,t", [
    (64, 16, 32, 500), (100, 10, None, 200), (64, 8, 64, 60),
])
def test_sliding_window_patches_equal_jax(tmp_path, seg, patch, step, t):
    rng = np.random.default_rng(t)
    data = rng.standard_normal((3, t)).astype(np.float32)
    got = unlabelled.sliding_window_patches(data, patch, seg, step)
    want = junlabelled.sliding_window_patches(data, patch, seg, step)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for name in ("B1_ecog.npz", "B2_ecog.npz", "B1_audio.npz"):
        np.savez(tmp_path / name, data=rng.standard_normal((3, max(t, seg))), sf=100.0)
    np.testing.assert_array_equal(
        unlabelled.collect_unlabelled_samples(str(tmp_path), patch, seg, step, ["ecog"]),
        junlabelled.collect_unlabelled_samples(str(tmp_path), patch, seg, step, ["ecog"]))
    with pytest.raises(ValueError, match="multiple"):
        unlabelled.sliding_window_patches(data, 7, seg)


def test_synthetic_subject_equals_jax(tmp_path):
    spec_kw = dict(n_channels=10, n_blocks=2, trials_per_block=5, ecog_sf=300.0,
                   audio_sf=800.0, seed=3)
    for seed in (0, 12):
        got = synthetic.generate_block(synthetic.SyntheticSpec(**spec_kw), seed)
        want = jsynthetic.generate_block(jsynthetic.SyntheticSpec(**spec_kw), seed)
        np.testing.assert_array_equal(got.ecog, want.ecog)
        np.testing.assert_array_equal(got.audio, want.audio)
        assert got.events == want.events
    synthetic.write_subject(str(tmp_path / "t"), 2, synthetic.SyntheticSpec(**spec_kw))
    jsynthetic.write_subject(str(tmp_path / "j"), 2, jsynthetic.SyntheticSpec(**spec_kw))
    files = []
    for d, _, names in os.walk(tmp_path / "j"):
        files += [os.path.relpath(os.path.join(d, n), tmp_path / "j") for n in names]
    assert len(files) == 4
    for rel in files:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel


def test_utils_equal_jax():
    for name in ("HS25_B13.wav", "B1_ecog.npz", "x_B007_audio.npz"):
        assert utils.extract_block_id(name) == jutils.extract_block_id(name)
    with pytest.raises(ValueError):
        utils.extract_block_id("nothing.wav")
    for args in (("B1_ecog.npz", "npz", ["ecog"]), ("B1_ecog.npz", "wav", ["ecog"]),
                 ("B1_ecog.npz", "npz", ["sound"]), ("B1_ecog.npz", "npz", None)):
        assert utils.match_filename(*args) == jutils.match_filename(*args)
    mapping = {"0": [1, 2, 3], "2": [3, 2, 1]}
    args = (mapping, np.array([0, 2, 2]), np.array([1, 0, 3]))
    np.testing.assert_array_equal(utils.prepare_tone_dynamics(*args),
                                  jutils.prepare_tone_dynamics(*args))
    with pytest.raises(ValueError, match="not found"):
        utils.prepare_tone_dynamics({"0": [1]}, np.array([5]), np.array([0]))
