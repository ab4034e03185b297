"""``world_slot_fill.train``: the share of the world edge set's dense slots
that held a valid edge over the traced steps, in percent: the port's
device-side running sums of the compacted world degrees and of the world
slots (``sgnn_tpu_torch.physics.mesh_simulator.MeshSimulator.
world_edge_count``, kept inside the captured step), read before and after
the traced steps by the MeshGraphNets runner (``runners/train_mgn.py``).
The rest of the world stage's work is masked. None where the port keeps
no such counter."""


def read(runner, breakdown):
    return getattr(runner, "world_fill", None)
