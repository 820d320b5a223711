"""The port's preprocess stage (``decode_tonal_langauge_tpu_torch/preprocess/``)
against the JAX package's.

Each step plugin's ``run`` and the stage as a whole
(``preprocess.main.run`` over a synthetic subject) go through both
packages on the CPU with the same inputs and parameters. Tolerances are
those of the ops' oracle tests in ``tests/test_ops_signal.py``, named in
each docstring; the whole stage is held at rtol/atol 1e-3.
"""

import builtins
import os
import sys
import types
from argparse import Namespace
from copy import deepcopy

import numpy as np
import pytest
import torch
import yaml

from decode_tonal_langauge_tpu.config import dict_to_namespace as jax_ns
from decode_tonal_langauge_tpu.data.synthetic import SyntheticSpec, write_subject
from decode_tonal_langauge_tpu.preprocess import main as jmain
from decode_tonal_langauge_tpu.preprocess import preprocessor as jpre
from decode_tonal_langauge_tpu.preprocess.signal import car_rereference as jcar
from decode_tonal_langauge_tpu.preprocess.signal import channel_zscore as jchz
from decode_tonal_langauge_tpu.preprocess.signal import downsample as jds
from decode_tonal_langauge_tpu.preprocess.signal import frequency_filter as jff
from decode_tonal_langauge_tpu.preprocess.signal import rolling_zscore as jroll
from decode_tonal_langauge_tpu.preprocess.signal import zscore_rereference as jzs
from decode_tonal_langauge_tpu_torch import registry
from decode_tonal_langauge_tpu_torch.config import dict_to_namespace, load_config
from decode_tonal_langauge_tpu_torch.preprocess import main as tmain
from decode_tonal_langauge_tpu_torch.preprocess import preprocessor as tpre
from decode_tonal_langauge_tpu_torch.preprocess.io import npz_blocks, tdt_blocks
from decode_tonal_langauge_tpu_torch.preprocess.pipelines import subject_block
from decode_tonal_langauge_tpu_torch.preprocess.signal import car_rereference as tcar
from decode_tonal_langauge_tpu_torch.preprocess.signal import channel_zscore as tchz
from decode_tonal_langauge_tpu_torch.preprocess.signal import downsample as tds
from decode_tonal_langauge_tpu_torch.preprocess.signal import frequency_filter as tff
from decode_tonal_langauge_tpu_torch.preprocess.signal import rolling_zscore as troll
from decode_tonal_langauge_tpu_torch.preprocess.signal import zscore_rereference as tzs

TDT_SF = 3051.7578125
HILBERT = {"method": "hilbert", "params": {"freq_ranges": [70, 110], "envelope": True}}
# The bench's band, for long signals (the |H|^2 route). Short signals take
# the (b, a) filtfilt route, where a 0.3 Hz edge diverges in f32 in both
# packages (SciPy float64 disagrees with each by ~1e6), so they get a band
# with the edges of the JAX oracle's ``test_filtfilt_matches_scipy``.
BUTTER = {"method": "butter", "params": {"freqs": [0.3, 100], "order": 4}}
BUTTER_SHORT = {"method": "butter", "params": {"freqs": [10, 90], "order": 4}}
FIR = {"method": "fir", "params": {"order": 90, "center_frequencies": [80.0, 110.0]}}


def _sig(c, t, seed=0):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(np.float32)


def _both(jmod, tmod, x, **params):
    """Run one step plugin in each package on the same input and params;
    returns (port output, JAX output, port params, JAX params)."""
    jp, tp = Namespace(**deepcopy(params)), Namespace(**deepcopy(params))
    ref = np.asarray(jmod.run(x, jp))
    ours = tmod.run(torch.from_numpy(x), tp)
    assert isinstance(ours, torch.Tensor)
    return ours.numpy(), ref, tp, jp


class TestStepPlugins:
    @pytest.mark.parametrize(
        "sf,t,method,tol",
        [
            (1000.0, 2000, "auto", (2e-4, 2e-4)),  # FFT route
            (1000.0, 2000, "poly", (1e-4, 1e-5)),
            (3052.0, 30520, "auto", (1e-4, 1e-5)),  # strided conv route
            (TDT_SF, 30518, "auto", (1e-4, 1e-5)),  # gather route
        ],
    )
    def test_downsample(self, sf, t, method, tol):
        """Output and ``signal_freq``; rtol/atol 2e-4 on the FFT route
        (``test_matches_scipy``), 1e-4/1e-5 on the polyphase routes
        (``test_polyphase_matches_scipy``)."""
        ours, ref, tp, jp = _both(
            jds, tds, _sig(3, t), signal_freq=sf, downsample_freq=400,
            resample_method=method,
        )
        assert tp.signal_freq == jp.signal_freq == 400
        assert ours.shape == ref.shape == (3, int(t * 400 / sf))
        np.testing.assert_allclose(ours, ref, rtol=tol[0], atol=tol[1])

    @pytest.mark.parametrize("t", [1000, 20000])
    @pytest.mark.parametrize("as_namespace", [False, True])
    def test_frequency_filter(self, t, as_namespace):
        """Hilbert, Butterworth and FIR bands concatenated on the channel
        axis; at 20000 samples the Hilbert bank runs blocked and the
        Butterworth band in the frequency domain. rtol 5e-3, atol 5e-4:
        the Hilbert and Butterworth oracles' (``test_matches_numpy_oracle``,
        ``test_butter_filter_lowpass``); FIR's is tighter."""
        bands = [HILBERT, BUTTER if t > 8192 else BUTTER_SHORT, FIR]
        if as_namespace:  # as the stage's dict_to_namespace hands them over
            bands = dict_to_namespace(bands)
        ours, ref, tp, jp = _both(jff, tff, _sig(3, t), signal_freq=400.0, bands=bands)
        assert ours.shape == ref.shape == (9, t)
        np.testing.assert_allclose(ours, ref, rtol=5e-3, atol=5e-4)
        assert tp.signal_freq == 400.0

    @pytest.mark.parametrize(
        "bands,match",
        [
            (None, "bands must"),
            ([{"method": "hilbert", "params": {}}], "freq_ranges"),
            ([{"method": "butter", "params": {}}], "freqs"),
            ([{"method": "fir", "params": {"order": 4}}], "center_frequencies"),
            ([{"method": "wavelet"}], "Unknown filter method"),
        ],
    )
    def test_frequency_filter_errors(self, bands, match):
        x = _sig(2, 100)
        for mod, data in ((jff, x), (tff, torch.from_numpy(x))):
            with pytest.raises(ValueError, match=match):
                mod.run(data, Namespace(signal_freq=400.0, bands=bands))

    def test_zscore_rereference(self):
        """rtol/atol 1e-4 (``test_interval_zscore``)."""
        x = _sig(3, 1000) + 5.0
        ours, ref, tp, _ = _both(
            jzs, tzs, x, signal_freq=100.0, rereference_interval=[0.0, 2.0]
        )
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
        assert tp.signal_freq == 100.0

    @pytest.mark.parametrize(
        "params,match",
        [
            ({"signal_freq": 100.0}, "rereference_interval"),
            ({"signal_freq": 100.0, "rereference_interval": [0.0, 20.0]}, "out of bounds"),
            ({"signal_freq": 100.0, "rereference_interval": [2.0, 1.0]}, "less than"),
        ],
    )
    def test_zscore_rereference_errors(self, params, match):
        x = _sig(2, 1000)
        for mod, data in ((jzs, x), (tzs, torch.from_numpy(x))):
            with pytest.raises(ValueError, match=match):
                mod.run(data, Namespace(**params))

    @pytest.mark.parametrize("exclude", [[], [1, 4], None])
    def test_car_rereference(self, exclude):
        """rtol/atol 1e-5 (``TestRereference::test_car``)."""
        ours, ref, _, _ = _both(
            jcar, tcar, _sig(6, 500), signal_freq=400.0, exclude_channels=exclude
        )
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="list"):
            tcar.run(torch.zeros(2, 4), Namespace(exclude_channels=(0,)))

    @pytest.mark.parametrize("preserve_nans", [True, False])
    def test_channel_zscore(self, preserve_nans):
        """rtol/atol 1e-4 (``test_channel_zscore``), NaNs where JAX has them."""
        x = _sig(4, 800)
        x[1, 3] = np.nan
        ours, ref, _, _ = _both(jchz, tchz, x, preserve_nans=preserve_nans)
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        np.testing.assert_allclose(
            np.nan_to_num(ours), np.nan_to_num(ref), rtol=1e-4, atol=1e-4
        )

    @pytest.mark.parametrize("preserve_nans", [True, False])
    def test_rolling_zscore(self, preserve_nans):
        """rtol/atol 2e-3 (``test_rolling_zscore_matches_pandas``); column 0
        NaN on both sides unless filled."""
        ours, ref, _, _ = _both(
            jroll, troll, _sig(3, 700), signal_freq=100.0, window_length=0.5,
            preserve_nans=preserve_nans,
        )
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        assert np.isnan(ours[:, 0]).all() == preserve_nans
        np.testing.assert_allclose(
            np.nan_to_num(ours), np.nan_to_num(ref), rtol=2e-3, atol=2e-3
        )
        with pytest.raises(ValueError, match="window_size"):
            troll.run(torch.zeros(2, 8), Namespace(signal_freq=1.0, window_length=1))


class TestPreprocessor:
    STEPS = [
        {"module": "downsample", "params": {"downsample_freq": 200}},
        {"module": "frequency_filter", "params": {"bands": [HILBERT, BUTTER_SHORT]}},
        {"module": "zscore_rereference", "params": {"rereference_interval": [0.0, 1.0]}},
    ]

    def test_param_collision(self):
        steps = [
            {"module": "channel_zscore", "params": {"preserve_nans": True}},
            {"module": "channel_zscore", "params": {"preserve_nans": False}},
        ]
        x = _sig(2, 500)
        with pytest.raises(ValueError, match="already exists"):
            jpre.preprocess_signal(x, steps, Namespace(signal_freq=400.0))
        with pytest.raises(ValueError, match="already exists"):
            tpre.preprocess_signal(x, steps, Namespace(signal_freq=400.0), device="cpu")

    def test_preprocess_signal_matches_jax(self):
        """The whole chain; rtol/atol 1e-3, the stage's tolerance."""
        x = _sig(3, 2000)
        ref, jfreq = jpre.preprocess_signal(x, self.STEPS, Namespace(signal_freq=400.0))
        ours, freq = tpre.preprocess_signal(
            x, self.STEPS, Namespace(signal_freq=400.0), device="cpu"
        )
        assert freq == jfreq == 200
        assert ours.device.type == "cpu" and ours.shape == (6, 1000)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-3)

    def test_figures(self, tmp_path):
        """With a figure directory each step writes the JAX package's
        figure, and the output is the one without figures."""
        x = _sig(3, 2000)
        dirs = {k: tmp_path / k for k in ("jax", "torch")}
        for d in dirs.values():
            d.mkdir()
        jpre.preprocess_signal(
            x, self.STEPS, Namespace(signal_freq=400.0), figure_dir=str(dirs["jax"])
        )
        ours, _ = tpre.preprocess_signal(
            x, self.STEPS, Namespace(signal_freq=400.0), figure_dir=str(dirs["torch"]),
            device="cpu",
        )
        plain, _ = tpre.preprocess_signal(
            x, self.STEPS, Namespace(signal_freq=400.0), device="cpu"
        )
        names = sorted(os.listdir(dirs["torch"]))
        assert names == sorted(os.listdir(dirs["jax"])) and len(names) == 3
        assert torch.equal(ours, plain)

    def test_modalities_inject_sf(self):
        """``<modality>_sf`` becomes the steps' ``signal_freq`` and is
        updated; a modality without steps passes through untouched."""
        rng = np.random.default_rng(0)
        data = {
            "ecog": rng.standard_normal((2, 2000)).astype(np.float32),
            "ecog_sf": 1000.0,
            "audio": rng.standard_normal((1, 4000)).astype(np.float32),
            "audio_sf": 2000.0,
        }
        cfg = {
            "ecog": {
                "type": "signal",
                "preprocessing": {
                    "steps": [{"module": "downsample", "params": {"downsample_freq": 400}}]
                },
            },
            "audio": {"type": "signal"},
        }
        ref = jpre.preprocess_modalities(dict(data), cfg, jax_ns({}))
        out = tpre.preprocess_modalities(dict(data), cfg, dict_to_namespace({}), device="cpu")
        assert out["ecog_sf"] == ref["ecog_sf"] == 400
        assert out["ecog"].shape == (2, 800)
        np.testing.assert_allclose(out["ecog"].numpy(), np.asarray(ref["ecog"]),
                                   rtol=2e-4, atol=2e-4)
        assert out["audio"] is data["audio"] and out["audio_sf"] == 2000.0

    @pytest.mark.parametrize("cfg,err", [({"ecog": {}}, KeyError),
                                         ({"ecog": {"type": "text", "preprocessing": {
                                             "steps": [{"module": "downsample"}]}}}, ValueError)])
    def test_modalities_errors(self, cfg, err):
        data = {"ecog": _sig(1, 100), "ecog_sf": 100.0}
        with pytest.raises(err):
            tpre.preprocess_modalities(data, cfg, dict_to_namespace({}), device="cpu")

    def test_registry(self):
        for name in ("preprocess.downsample", "preprocess.signal.downsample", "downsample"):
            assert registry.resolve(name) is tds
        assert registry.resolve("preprocess.io.npz_blocks") is npz_blocks
        assert registry.resolve("decode_tonal_langauge_tpu_torch.preprocess.main") is tmain
        registry.register_alias("my_downsample", "decode_tonal_langauge_tpu_torch."
                                "preprocess.signal.downsample")
        try:
            assert registry.resolve("my_downsample") is tds
        finally:
            del registry._ALIASES["my_downsample"]


class TestBlockIO:
    def _stub_tdt(self, monkeypatch, ecog, audio):
        streams = types.SimpleNamespace(
            EOG1=types.SimpleNamespace(data=ecog, fs=3051.76),
            ANIN=types.SimpleNamespace(data=audio, fs=24414.0),
        )
        stub = types.ModuleType("tdt")
        stub.read_block = lambda path: types.SimpleNamespace(streams=streams)
        monkeypatch.setitem(sys.modules, "tdt", stub)

    def test_tdt_load_and_save(self, monkeypatch, tmp_path):
        """EOG1 is the ECoG, the first ANIN row the audio; the writer
        takes tensors and arrays alike."""
        rng = np.random.default_rng(0)
        ecog = rng.standard_normal((8, 100)).astype(np.float32)
        audio = rng.standard_normal((4, 200)).astype(np.float32)
        self._stub_tdt(monkeypatch, ecog, audio)
        data = tdt_blocks.load_block("/fake/tank/HS1-B2")
        assert data["audio"].shape == (1, 200) and data["ecog_sf"] == 3051.76
        data["ecog"] = torch.from_numpy(data["ecog"])
        tdt_blocks.save_block(str(tmp_path), 7, 3, data)
        for mod, expect in (("ecog", ecog), ("audio", audio[:1])):
            f = np.load(tmp_path / "subject_7" / f"B3_{mod}.npz")
            assert set(f.files) == {"data", "sf"}
            np.testing.assert_array_equal(f["data"], expect)

    def test_missing_tdt_package_errors_clearly(self, monkeypatch):
        monkeypatch.delitem(sys.modules, "tdt", raising=False)
        real_import = builtins.__import__

        def no_tdt(name, *args, **kwargs):
            if name == "tdt":
                raise ImportError("No module named 'tdt'")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_tdt)
        with pytest.raises(ImportError, match="npz_blocks"):
            tdt_blocks.load_block("/fake/tank")

    def test_npz_missing_raw(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="raw.npz"):
            npz_blocks.load_block(str(tmp_path))

    def test_block_names(self, tmp_path, capsys):
        assert subject_block.get_block_id("HS3-B12") == 12
        assert subject_block.get_block_id("notes") is None
        assert "Skipping" in capsys.readouterr().out


def _stage_config(raw_dir, out_dir, downsample_freq, butter=BUTTER_SHORT, figures=False):
    """The chain of ``tests/test_preprocess.py``'s stage config plus a
    Butterworth band."""
    steps = [
        {"module": "downsample", "params": {"downsample_freq": downsample_freq}},
        {"module": "frequency_filter", "params": {"bands": [HILBERT, butter]}},
        {"module": "zscore_rereference", "params": {"rereference_interval": [0.0, 5.0]}},
    ]
    return {
        "preprocess": {
            "module": "preprocess_main",
            "params": {
                "pipeline": {
                    "module": "preprocess.pipelines.subject_block",
                    "params": {"subject_dirs": ["Sub1"], "subject_ids": [1],
                               "figures": figures},
                },
                "io": {
                    "module": "preprocess.io.npz_blocks",
                    "params": {"root_dir": raw_dir, "output_dir": out_dir},
                },
                "preprocessor": {"module": "preprocess.preprocessor"},
                "modalities": {
                    "ecog": {"type": "signal", "preprocessing": {"steps": steps}},
                    "audio": {"type": "signal"},
                },
            },
        }
    }


class TestStage:
    @pytest.mark.parametrize(
        "ecog_sf,trials,target,butter",
        [
            # FFT resample, full-length Hilbert, (b, a) filtfilt
            (500.0, 4, 250, BUTTER_SHORT),
            # gather resample (1024 phases), blocked Hilbert, |H|^2 Butterworth
            (TDT_SF, 12, 1000, BUTTER),
        ],
    )
    def test_stage_matches_jax(self, tmp_path, ecog_sf, trials, target, butter):
        """Both packages' ``preprocess.main.run`` on one synthetic subject
        (8 channels, 2 blocks): the same setup directory name, provenance,
        files and rates, and arrays within rtol/atol 1e-3."""
        spec = SyntheticSpec(n_channels=8, n_blocks=2, trials_per_block=trials,
                             ecog_sf=ecog_sf, audio_sf=1000.0)
        raw = str(tmp_path / "raw")
        write_subject(raw, 1, spec)
        jdir = jmain.run(_stage_config(raw, str(tmp_path / "jax"), target, butter))
        tdir = tmain.run(_stage_config(raw, str(tmp_path / "torch"), target, butter),
                         device="cpu")
        assert os.path.basename(jdir) == os.path.basename(tdir)

        def provenance(d):
            with open(os.path.join(d, "config.yaml")) as f:
                cfg = yaml.safe_load(f)
            cfg["preprocess"]["io"]["output_dir"] = None
            return cfg

        assert provenance(jdir) == provenance(tdir)
        jsub, tsub = os.path.join(jdir, "subject_1"), os.path.join(tdir, "subject_1")
        assert sorted(os.listdir(jsub)) == sorted(os.listdir(tsub)) == [
            "B1_audio.npz", "B1_ecog.npz", "B2_audio.npz", "B2_ecog.npz"]
        for name in os.listdir(tsub):
            ours, ref = np.load(os.path.join(tsub, name)), np.load(os.path.join(jsub, name))
            assert float(ours["sf"]) == float(ref["sf"])
            assert ours["data"].dtype == ref["data"].dtype == np.float32
            assert ours["data"].shape == ref["data"].shape
            np.testing.assert_allclose(ours["data"], ref["data"], rtol=1e-3, atol=1e-3)
        ecog = np.load(os.path.join(tsub, "B1_ecog.npz"))
        assert float(ecog["sf"]) == target and ecog["data"].shape[0] == 16

    def test_cli_figures_and_parallel(self, tmp_path, capsys):
        """The CLI on the CPU with figures on and a ``parallel:`` key: one
        asking for 2 ranks in one process raises, ``auto`` runs the one
        process; the same setup directory is reused on a second run."""
        spec = SyntheticSpec(n_channels=4, n_blocks=1, trials_per_block=2,
                             ecog_sf=500.0, audio_sf=1000.0)
        raw = str(tmp_path / "raw")
        write_subject(raw, 1, spec)
        config = _stage_config(raw, str(tmp_path / "out"), 250, figures=True)
        config["parallel"] = {"data": 2}
        path = tmp_path / "config.yaml"
        path.write_text(yaml.safe_dump(config))
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            tmain.main([str(path), "--device", "cpu"])
        config["parallel"] = "auto"
        path.write_text(yaml.safe_dump(config))
        setup_dir = tmain.main([str(path), "--device", "cpu"])
        assert "parallel:" not in capsys.readouterr().out
        figs = os.path.join(setup_dir, "figures", "subject_1", "block_1", "ecog")
        assert sorted(os.listdir(figs)) == [
            "step1_downsample.png", "step2_frequency_filter.png",
            "step3_zscore_rereference.png"]
        assert tmain.run(load_config(str(path)), device="cpu") == setup_dir

    def test_plugins_without_device_argument(self, tmp_path, capsys):
        """A pipeline plugin with the reference's five-argument ``run``
        and a preprocessor plugin without ``device`` keep working."""
        spec = SyntheticSpec(n_channels=4, n_blocks=1, trials_per_block=2,
                             ecog_sf=500.0, audio_sf=1000.0)
        raw = str(tmp_path / "raw")
        write_subject(raw, 1, spec)
        legacy_pre = types.ModuleType("legacy_torch_preprocessor")
        legacy_pre.preprocess_modalities = (
            lambda data_dict, cfg, params, figure_dir=None: tpre.preprocess_modalities(
                data_dict, cfg, params, figure_dir=figure_dir, device="cpu"))
        legacy_pipe = types.ModuleType("legacy_torch_pipeline")
        legacy_pipe.run = lambda pp, iop, iom, prem, mods: subject_block.run(
            pp, iop, iom, prem, mods)
        config = _stage_config(raw, str(tmp_path / "out"), 250)
        params = config["preprocess"]["params"]
        params["preprocessor"]["module"] = "legacy_torch_preprocessor"
        params["pipeline"]["module"] = "legacy_torch_pipeline"
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "legacy_torch_preprocessor", legacy_pre)
            mp.setitem(sys.modules, "legacy_torch_pipeline", legacy_pipe)
            setup_dir = tmain.run(config, device="cpu")
        assert os.path.exists(os.path.join(setup_dir, "subject_1", "B1_ecog.npz"))
        assert "takes no `device`" not in capsys.readouterr().out
