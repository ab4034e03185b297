"""Worker of tests/test_torch_port_multihost.py: one data-parallel step of
the port over a gloo process group on the CPU (``--device cuda``: an NCCL
group, process r on card r; tests/test_torch_port_cuda.py).

With ``--nprocs 2`` each process joins the group at ``--port``, takes its
half of one deterministic global batch (``multihost.host_batch_slice``,
``make_global_batch``) and steps a one-device mesh: the step draws the
whole batch's noise, keeps its rows and sums the gradients over the
processes in rank order. With ``--nprocs 1`` it is the reference: no group,
the same global batch over a ``data_parallel: 2`` mesh of two CPU
replicas. Each writes its loss and parameters after the step to ``--out``.
"""

import argparse

import numpy as np
import torch

from sgnn_tpu_torch.parallel import multihost
from sgnn_tpu_torch.parallel.data_parallel import DataParallelStep
from sgnn_tpu_torch.parallel.mesh import make_mesh
from sgnn_tpu_torch.physics import simulator as tsim
from sgnn_tpu_torch.train import train as ttrain
from sgnn_tpu_torch.train.config import TrainConfig

S, N, B = 5, 32, 4


def global_batch():
    rng = np.random.default_rng(0)  # the same on every process
    xs, ys = np.meshgrid(np.arange(8) * 0.5, np.arange(4) * 0.5, indexing="ij")
    pos = np.stack([xs.ravel() - 1.0, ys.ravel()], -1).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[3, -5:] = False  # the processes' masked counts differ
    return {
        "positions": (pos[None, :, None, :] + rng.normal(scale=0.005, size=(B, N, S, 2)).cumsum(2)).astype(np.float32),
        "next_position": (pos[None] + rng.normal(scale=0.01, size=(B, N, 2))).astype(np.float32),
        "next_strain": rng.normal(size=(B, N)).astype(np.float32),
        "particle_type": np.zeros((B, N), np.int32),
        "node_mask": mask,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = p.parse_args()
    torch.set_num_threads(1)
    dev = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if args.nprocs > 1:
        multihost.initialize(f"tcp://localhost:{args.port}", world_size=args.nprocs, rank=args.rank, device=dev)
    assert multihost.process_index() == args.rank and multihost.process_count() == args.nprocs
    sim_cfg = tsim.SimulatorConfig(dim=2, latent_dim=16, num_message_passing_steps=2, input_sequence_length=S,
                                   connectivity_radius=0.6, max_neighbors=20)
    cfg = TrainConfig(batch_size=B, noise_std=0.001, input_sequence_length=S, hidden_dim=16, layers=2,
                      data_parallel=2)
    stats = tsim.NormStats(torch.zeros(2), torch.ones(2), torch.zeros(2), torch.ones(2))
    sim = tsim.simulator_init(sim_cfg, generator=torch.Generator().manual_seed(0), device=dev)
    mesh = make_mesh(data=2 if args.nprocs == 1 else 1, devices=[dev, dev])
    step = DataParallelStep(lambda m, d: ttrain.make_loss_fn(m, sim_cfg, stats.to(d), cfg), sim, mesh,
                            ttrain.make_optimizer(sim, cfg), ttrain.lr_schedule(cfg), cfg.noise_std,
                            torch.Generator(device=dev).manual_seed(7))
    per = multihost.host_batch_slice(B)
    local = {k: v[args.rank * per : (args.rank + 1) * per] for k, v in global_batch().items()}
    metrics = step(multihost.make_global_batch(local, mesh), 0)
    params = torch.cat([t.reshape(-1) for t in sim.state_dict().values()])
    np.savez(args.out, loss=metrics["train/loss"].cpu().numpy(), params=params.cpu().numpy())
    multihost.shutdown()


if __name__ == "__main__":
    main()
