"""The port's own copy of ``repro/runtime/elastic.py``, held to the original by
``tests/test_torch_runtime_ft.py``; it imports nothing of the package.
``rescale`` is the reference's: it hands ``shardings=`` to the manager's
``restore``, as the reference's ``CheckpointManager`` takes it; the port's
``CheckpointManager.restore`` takes ``device=`` instead, and nothing in the
port calls ``rescale``.

Elastic scaling: resume a job on a different DP width.

Parameters and ZeRO-1 optimizer state are stored UNSHARDED in checkpoints
(checkpoint/manager.py), so rescaling is: rebuild shardings for the new
mesh, `restore(..., shardings=new)`, and rescale the data pipeline's
global batch.  The only semantic knobs are batch/LR rescaling, handled
here explicitly so restarts are bitwise-documented.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ElasticPlan:
    old_dp: int
    new_dp: int
    old_global_batch: int
    keep_global_batch: bool = True     # True: same batch, different per-host
    lr_scale: float = 1.0

    @property
    def new_global_batch(self) -> int:
        if self.keep_global_batch:
            if self.old_global_batch % self.new_dp:
                raise ValueError(
                    f"global batch {self.old_global_batch} not divisible by "
                    f"new dp {self.new_dp}"
                )
            return self.old_global_batch
        return self.old_global_batch * self.new_dp // self.old_dp

    @property
    def effective_lr_scale(self) -> float:
        if self.keep_global_batch:
            return 1.0
        # linear-scaling rule when the batch actually changes
        return self.lr_scale * self.new_dp / self.old_dp

    @property
    def capacity_fraction(self) -> float:
        """Throughput fraction retained by the shrunken job — the
        goodput multiplier the availability campaign charges while a
        shrink is in effect (per-replica step time is unchanged; only
        replica count drops)."""
        return self.new_dp / self.old_dp


def shrink_plan(
    old_dp: int, old_global_batch: int, lost_chips: int, total_chips: int
) -> ElasticPlan:
    """The DP-shrink plan for losing ``lost_chips`` of ``total_chips``:
    drop the DP replicas that lived on the lost capacity (at least one),
    keeping per-replica batch constant (the global batch shrinks with
    the fleet — the linear-scaling LR rule applies on resume)."""
    chips_per_replica = max(1, total_chips // max(1, old_dp))
    lost_replicas = -(-lost_chips // chips_per_replica)  # ceil
    new_dp = max(1, old_dp - lost_replicas)
    return ElasticPlan(
        old_dp=old_dp,
        new_dp=new_dp,
        old_global_batch=old_global_batch,
        keep_global_batch=False,
    )


def rescale(
    manager,
    step: int,
    tree_like,
    new_shardings,
    plan: ElasticPlan,
):
    """Restore a checkpoint onto the new mesh; returns (state, plan)."""
    state = manager.restore(step, tree_like, shardings=new_shardings)
    return state, plan
