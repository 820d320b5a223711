"""The port's multi-device layer in one process, mirroring
``tests/test_parallel.py``: ``host_shard``, ``mesh_from_config``, batch
rounding, ``initialize`` and ``barrier`` without a launcher, and
``dense_head_sharding``'s assignment on the CNN (under a one-rank gloo
group of a ("data", "model") mesh, destroyed after the test).

Every check here is exact: the layer's one-process behaviour is integer
bookkeeping and the identity.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from decode_tonal_langauge_tpu_torch.models.deep import CNNClassifier
from decode_tonal_langauge_tpu_torch.models.simple import LogisticRegressionClassifier
from decode_tonal_langauge_tpu_torch.parallel import distributed
from decode_tonal_langauge_tpu_torch.parallel.distributed import barrier, host_shard
from decode_tonal_langauge_tpu_torch.parallel.mesh import (
    DataParallelLayout,
    fetch_global,
    make_mesh,
    mesh_from_config,
)
from decode_tonal_langauge_tpu_torch.parallel.train_step import dense_head_sharding
from decode_tonal_langauge_tpu_torch.training.trainer import ClassifierTrainer

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)


class TestHostShard:
    def test_single_process_is_identity(self):
        assert host_shard(["a", "b", "c"]) == ["a", "b", "c"]

    def test_round_robin(self):
        items = list(range(10))
        shards = [host_shard(items, p, 3) for p in range(3)]
        assert shards == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
        assert sorted(sum(shards, [])) == items  # disjoint and complete

    def test_bad_process_id(self):
        with pytest.raises(ValueError):
            host_shard([1, 2], process_id=5, process_count=2)


class TestMeshFromConfig:
    def test_absent_or_single_is_none(self, no_launcher):
        assert mesh_from_config(None) is None
        assert mesh_from_config({}) is None
        assert mesh_from_config({"data": 1}) is None

    def test_auto_resolves_to_one_process(self, no_launcher):
        assert mesh_from_config("auto") is None
        assert mesh_from_config({"data": "auto"}) is None

    def test_too_many_raises_and_names_torchrun(self, no_launcher):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            mesh_from_config({"data": 2})
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
            mesh_from_config({"data": 2, "model": 2})
        with pytest.raises(ValueError):
            mesh_from_config("not-a-mapping")

    def test_make_mesh_needs_a_group(self, no_launcher):
        with pytest.raises(ValueError, match="torchrun"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh(1)


class TestLayout:
    def test_batch_size_rounds_to_data_axis(self):
        """Batch 5 over a data axis of 8 becomes 8, as in JAX."""
        layout = DataParallelLayout(None)
        layout.dp = 8
        assert layout.round_batch(5) == 8
        assert layout.round_batch(16) == 16
        assert DataParallelLayout(None).round_batch(5) == 5

    def test_no_mesh_is_the_identity(self):
        layout = DataParallelLayout(None)
        x = torch.arange(12.0).reshape(6, 2)
        stacks = (np.zeros((2, 4, 3)), np.ones((2, 4)))
        assert layout.writer and layout.dp == 1
        assert layout.shard(x) is x and layout.gather(x) is x
        assert all(a is b for a, b in zip(layout.place_stacks(*stacks), stacks))
        grads = [torch.ones(3), torch.zeros(2, 2)]
        assert all(a is b for a, b in zip(layout.reduce_sum(grads), grads))
        np.testing.assert_array_equal(fetch_global(None, x), x.numpy())
        layout.barrier("test")  # must not raise or hang

    def test_trainer_without_mesh_keeps_its_batch(self):
        t = ClassifierTrainer(LogisticRegressionClassifier(4, 2), n_classes=2,
                              batch_size=5, device="cpu")
        assert t.batch_size == 5 and t.mesh is None


class TestDistributed:
    def test_initialize_noop_without_launcher(self, no_launcher):
        assert distributed.initialize() is False
        assert not dist.is_initialized()
        assert distributed.process_index() == 0 and distributed.process_count() == 1

    def test_barrier_noop_single_process(self):
        barrier("test")  # must not raise or hang

    def test_launch_env_recipes(self, no_launcher, monkeypatch):
        assert distributed._launch_env() is None
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("JAX_PROCESS_ID", "3")
        assert distributed._launch_env() == ("10.0.0.1:1234", 4, 3, 0)
        for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"),
                           ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500")):
            monkeypatch.setenv(key, value)
        assert distributed._launch_env() == ("env://", 2, 1, 1)  # torchrun's wins
        assert distributed._init_method("10.0.0.1:1234") == "tcp://10.0.0.1:1234"
        assert distributed._init_method("file:///tmp/s") == "file:///tmp/s"


@pytest.fixture
def one_rank_group(tmp_path, no_launcher):
    distributed.initialize(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dense_head_sharding_on_the_cnn(one_rank_group):
    """Under a ("data", "model") mesh the CNN's fc1/fc2 weights and biases
    split on the output dimension and the convolutions stay replicated;
    without a model axis everything is replicated."""
    model = CNNClassifier(2, 128, 4)
    placements = dense_head_sharding(make_mesh(1, ("data", "model"), (1, 1)), model)
    for name in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"):
        assert placements[name] == Shard(0), name
    assert placements["convs.1.weight"] == Replicate()
    assert placements["convs.0.weight"] == Replicate()
    assert set(placements) == {n for n, _ in model.named_parameters()}
    flat = dense_head_sharding(make_mesh(1), model)
    assert set(flat.values()) == {Replicate()}
