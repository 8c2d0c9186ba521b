"""The multi-slice topology tier: the two-hop exchange over a two-tier
fabric (port of ``cylon_tpu/topo``).

* :mod:`cylon_tpu_torch.topo.model`: slice discovery (the
  ``CYLON_TPU_TORCH_SLICES`` declaration, or the processes' hosts), the
  slice-major tier model, gateways and the voted :class:`TopologyPlan`;
* :mod:`cylon_tpu_torch.topo.exchange`: the two-hop route, bit- and
  order-equal to the flat one.

``parallel/shuffle.exchange`` loads the route lazily.
"""

from .model import (Topology, TopologyPlan, declared_slices,  # noqa: F401
                    ensure_adopted, gateway_of, hier_plan, last_plan,
                    slice_major_order, tier_split, topology)
