"""The port's small public helpers against their JAX counterparts:
``training.trainer.train_val_test_split`` gives the same index arrays for
the same ``(n, ratios, seed)``, and ``config.append_data_json`` leaves the
same JSON document behind for a new file, a merge into an existing one
and an unreadable one."""

import json

import numpy as np
import pytest

from decode_tonal_langauge_tpu import config as jconfig
from decode_tonal_langauge_tpu.training import trainer as jtrainer
from decode_tonal_langauge_tpu_torch import config
from decode_tonal_langauge_tpu_torch.training import trainer


@pytest.mark.parametrize("n,ratios,seed", [
    (160, (0.7, 0.1, 0.2), 7270),
    (160, (0.7, 0.1, 0.2), 860),
    (37, (0.6, 0.2, 0.2), 3),
    (10, (0.8, 0.1, 0.1), 42),
])
def test_train_val_test_split_equals_jax(n, ratios, seed):
    got = trainer.train_val_test_split(n, *ratios, seed=seed)
    want = jtrainer.train_val_test_split(n, *ratios, seed=seed)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(n))


def test_append_data_json_merges_as_jax(tmp_path):
    for module, name in ((config, "port"), (jconfig, "jax")):
        fresh, merged, broken = (tmp_path / f"{name}_{k}.json" for k in ("a", "b", "c"))
        module.append_data_json(str(fresh), {"x": 1, "y": [1, 2]})
        merged.write_text(json.dumps({"x": 0, "z": {"k": "v"}}))
        module.append_data_json(str(merged), {"x": 1, "y": [1, 2]})
        broken.write_text("{not json")
        module.append_data_json(str(broken), {"y": 2})
    for key in ("a", "b", "c"):
        port = (tmp_path / f"port_{key}.json").read_text()
        assert port == (tmp_path / f"jax_{key}.json").read_text()
    assert json.loads((tmp_path / "port_b.json").read_text()) == {
        "x": 1, "z": {"k": "v"}, "y": [1, 2]}
    assert json.loads((tmp_path / "port_c.json").read_text()) == {"y": 2}
