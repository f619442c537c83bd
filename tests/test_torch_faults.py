"""Two faults of the port against the reference, held on the CPU.

* ``reduce_sum`` of a host value under NCCL: NCCL reduces only CUDA
  tensors, so a Python scalar or a CPU tensor must go through the current
  CUDA device and come back as it came.  The backend query, the CUDA
  device and the all-reduce are patched, so no process group and no card
  are needed.
* Progress bars on process 0 only (``multigrad_tpu/utils/util.py``'s
  ``simple_grad_descent`` and ``optim/bfgs.py`` show theirs there only).
"""
import pytest
import torch
import torch.distributed as dist

from multigrad_tpu_torch.parallel.collectives import reduce_sum
from multigrad_tpu_torch.parallel.mesh import MeshComm
from multigrad_tpu_torch.utils import util


@pytest.fixture
def fake_group(monkeypatch):
    """A 2-rank group whose all-reduce doubles its tensor in place; yields
    a dict that records the backend to report, each ``Tensor.to`` target
    and the tensors all-reduced."""
    seen = {"backend": "nccl", "moves": [], "reduced": []}
    real_to = torch.Tensor.to

    def fake_to(self, *args, **kwargs):
        target = torch.device(args[0] if args else kwargs["device"])
        seen["moves"].append(target)
        # No card here: stand in for the CUDA copy with a CPU one.
        return self.clone() if target.type == "cuda" else real_to(self, target)

    def fake_all_reduce(tensor, op=None, group=None):
        seen["reduced"].append(tensor)
        tensor.mul_(2)

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: seen["backend"])
    monkeypatch.setattr(dist, "all_reduce", fake_all_reduce)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.Tensor, "to", fake_to)
    return seen


def test_reduce_sum_python_float_under_nccl(fake_group):
    out = reduce_sum(1.25, comm=MeshComm())
    assert fake_group["moves"] == [torch.device("cuda", 3)]
    assert len(fake_group["reduced"]) == 1
    assert type(out) is float and out == 2.5


def test_reduce_sum_cpu_tensor_under_nccl(fake_group):
    value = torch.tensor([1.0, -2.0])
    out = reduce_sum(value, comm=MeshComm())
    assert fake_group["moves"] == [torch.device("cuda", 3),
                                   torch.device("cpu")]
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert torch.equal(out, torch.tensor([2.0, -4.0]))
    assert torch.equal(value, torch.tensor([1.0, -2.0]))


def test_reduce_sum_under_gloo_stays_on_the_host(fake_group):
    fake_group["backend"] = "gloo"
    assert reduce_sum(3, comm=MeshComm()) == 6
    out = reduce_sum(torch.tensor(0.5), comm=MeshComm())
    assert fake_group["moves"] == [torch.device("cpu")]
    assert out.device.type == "cpu" and float(out) == 1.0


@pytest.mark.skipif(util.tqdm is None, reason="tqdm is not installed")
@pytest.mark.parametrize("rank", [0, 1])
def test_progress_bar_on_process_zero_only(monkeypatch, rank):
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    steps = util.trange(3, "Adam Gradient Descent Progress", progress=True)
    try:
        if rank == 0:
            assert not isinstance(steps, range) and len(steps) == 3
        else:
            assert steps == range(3)
    finally:
        if not isinstance(steps, range):
            steps.close()


def test_progress_bar_without_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert util.trange(2, progress=False) == range(2)
    steps = util.trange(2, progress=True)
    assert (steps == range(2)) if util.tqdm is None else len(steps) == 2
    if not isinstance(steps, range):
        steps.close()
