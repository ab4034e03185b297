"""Import hygiene of the port, its CUDA-by-default entry points, and the
kernel build helpers that run without a card."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.kernels import build
from sgnn_tpu_torch.physics import rollout as troll
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.scripts import gather_kernel_probe as tprobe
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.config import TrainConfig
from sgnn_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "sgnn_tpu")
SOURCES = sorted((REPO / "sgnn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_check_sees_through_aliases(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy as np\nfrom sgnn_tpu.ops import neighbors\nimport sgnn_tpu_torch.ops\n")
    assert [m for m in _imported(probe) if m.split(".")[0] in FORBIDDEN] == ["sgnn_tpu.ops"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_predict_needs_cuda_without_a_device(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.predict(TrainConfig(mode="rollout", model_file="model-best-000000"))


def test_train_needs_cuda_without_a_device(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(TrainConfig())


def test_entry_points_need_cuda_without_a_device(no_cuda):
    cfg = tsim.SimulatorConfig(latent_dim=8, num_message_passing_steps=1)
    with pytest.raises(RuntimeError):
        tsim.simulator_init(cfg)
    sim = tsim.simulator_init(cfg, device="cpu")
    stats = tsim.NormStats(*(torch.ones(2) for _ in range(4)))
    pos = np.zeros((4, 13, 2), np.float32)
    with pytest.raises(RuntimeError):
        troll.rollout(sim, cfg, stats, pos, np.zeros(4, np.int32), np.zeros((13, 4), np.float32))
    with pytest.raises(RuntimeError):
        ttrain.main(["--config", str(REPO / "configs" / "taylor2d_single_scale.yaml"), "--mode", "rollout"])


def test_ms_train_needs_cuda_without_a_device(no_cuda):
    from sgnn_tpu_torch.train import train_multi_scale as ttms

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttms.train(TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttms.main(["--config", str(REPO / "configs" / "taylor2d_multi_scale.yaml"), "--mode", "train"])


def test_parallel_entry_points_need_cuda_without_a_device(no_cuda):
    """A mesh takes CUDA devices unless it is given a list; the trainers'
    parallel runs and a process group on the default device need CUDA."""
    from sgnn_tpu_torch.parallel import make_mesh, multihost
    from sgnn_tpu_torch.train import train_multi_scale as ttms

    with pytest.raises(ValueError, match="need 2 CUDA devices, have 0"):
        make_mesh(data=2)
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(graph=2)
    assert make_mesh(graph=2, devices=["cpu", "cpu"]).one_device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize("tcp://localhost:1", world_size=1, rank=0)
    for kw in (dict(data_parallel=2), dict(graph_parallel=2, batch_size=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.train(TrainConfig(**kw))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.predict(TrainConfig(mode="rollout", model_file="model-best-000000", **kw))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttms.train(TrainConfig(data_parallel=2))


def test_probe_needs_cuda_without_a_device(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprobe.main([])


def test_the_walk_reaches_every_new_module():
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {"sgnn_tpu_torch/scripts/gather_kernel_probe.py", "sgnn_tpu_torch/ops/row_gather.py",
            "sgnn_tpu_torch/models/multi_scale.py", "sgnn_tpu_torch/train/train_multi_scale.py",
            "sgnn_tpu_torch/data/static_graph_loader.py", "sgnn_tpu_torch/physics/multi_scale_simulator.py",
            "sgnn_tpu_torch/parallel/mesh.py", "sgnn_tpu_torch/parallel/multihost.py",
            "sgnn_tpu_torch/parallel/data_parallel.py", "sgnn_tpu_torch/parallel/edge_partition.py",
            "sgnn_tpu_torch/utils/graph_debug.py", "sgnn_tpu_torch/utils/profiling.py",
            "sgnn_tpu_torch/utils/torch_import.py", "sgnn_tpu_torch/data/lsdyna_parser.py",
            "sgnn_tpu_torch/native/__init__.py", "sgnn_tpu_torch/native/build.py",
            "sgnn_tpu_torch/viz/render_rollout.py", "sgnn_tpu_torch/scripts/parity_vs_checkpoint.py"} <= names


def test_parity_driver_needs_cuda_without_a_device(no_cuda, tmp_path):
    from sgnn_tpu_torch.scripts import parity_vs_checkpoint

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity_vs_checkpoint.main(["--checkpoint", str(tmp_path / "c.npz"), "--input", str(tmp_path / "i.npz")])


def test_native_library_is_built_by_the_port_not_loaded_from_jax():
    from sgnn_tpu_torch import native

    assert native.SOURCE == REPO / "sgnn_tpu_torch" / "native" / "radius_search.cc"
    assert native.library_path().parent == REPO / "build" / "native"
    assert native.library_path().name.startswith("libradius_search-")


def test_resolve_device_passes_explicit_choices():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_rollout_refuses_a_simulator_on_another_device():
    cfg = tsim.SimulatorConfig(latent_dim=8, num_message_passing_steps=1)
    sim = tsim.simulator_init(cfg, device="meta")
    stats = tsim.NormStats(*(torch.ones(2) for _ in range(4)))
    with pytest.raises(ValueError, match="simulator lives on"):
        troll.rollout(sim, cfg, stats, np.zeros((4, 13, 2), np.float32), np.zeros(4, np.int32),
                      np.zeros((13, 4), np.float32), device="cpu")


def test_kernel_sources_and_build_paths():
    assert {"edge_block_fwd", "edge_block_bwd", "row_gather", "row_gather_bwd"} <= set(build.sources())
    lib = build.library_path("edge_block_fwd")
    assert lib.parent == REPO / "build" / "kernels"  # ignored by .gitignore's build/
    assert lib.name.startswith("libedge_block_fwd-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_library_name_covers_every_header(monkeypatch, tmp_path):
    """A source includes the headers of csrc; a header edit must rebuild
    every source, so the library name hashes the headers too."""
    assert "edge_block_tile.cuh" in [p.name for p in build.headers()]
    assert "edge_block_tile" not in build.sources()  # an include, not a source
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n')
    (tmp_path / "t.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    (tmp_path / "t.cuh").write_text("// two\n")
    assert build.library_path("k") != first
    (tmp_path / "t.cuh").write_text("// one\n")
    assert build.library_path("k") == first
    (tmp_path / "u.cuh").write_text("")
    assert build.library_path("k") != first


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
