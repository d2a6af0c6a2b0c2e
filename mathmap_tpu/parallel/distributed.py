"""Multi-process initialization — the distributed-comm backend slot.

The reference has NO distributed communication (pthread row-slices only,
SURVEY.md §2.2 comm row [unverified — mount empty, SURVEY.md §0]); this
module wires `jax.distributed` for renders that span several processes
(one per GPU, or several hosts). XLA inserts the collectives from the
shardings in parallel/shard.py and parallel/halo.py (NCCL between GPUs,
gloo between CPU processes) — there are no hand-written NCCL/MPI calls.

One process driving all the GPUs of a host needs none of this; the mesh
helpers use local devices. For several processes, every process calls

    from mathmap_tpu.parallel import distributed
    distributed.initialize("localhost:12355", num_processes=4, process_id=i)
    mesh = mesh.make_mesh(frames=2)     # all global devices

with the coordinator's address, the process count and its own index:
nothing in the environment tells JAX about the cluster.
"""

from __future__ import annotations


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-process render fleet.
    Idempotent."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as exc:  # already initialized
        # jax raises "distributed.initialize should only be called once."
        msg = str(exc).lower()
        if "already" not in msg and "once" not in msg:
            raise


def is_multihost() -> bool:
    import jax

    return jax.process_count() > 1


def local_slice_of(array):
    """The rows of a fully-sharded global render owned by this process —
    what this host should write to disk (frame-sharded animation outputs
    compose with CLI --resume for restartable multi-host batches)."""
    return [s.data for s in array.addressable_shards]
