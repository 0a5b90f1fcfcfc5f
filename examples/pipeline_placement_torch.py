"""The paper's technique applied to a device mesh, with the PyTorch port.

The twin of ``examples/pipeline_placement.py`` on ``repro_torch``: map a
pipeline-parallel stage graph (= "DFG") onto a device grid (= torus "CGRA")
with the same time solution + monomorphism space solution, so every stage
boundary is a single hop between neighbouring devices — a point-to-point
send to a neighbour instead of a long-haul route. It prints what the
reference example prints, except that the device order is meant for a
``torch.distributed`` device mesh. Host code only: no CUDA call.

    PYTHONPATH=src python examples/pipeline_placement_torch.py
"""

from repro_torch.core.placement import (
    device_order_for_pipeline, expert_groups_graph, linear_pipeline, place_stages,
)

for num_stages, mesh_shape in [(8, (4, 4)), (16, (4, 4)), (12, (4, 8)), (16, (16, 16))]:
    placement = place_stages(linear_pipeline(num_stages), mesh_shape)
    if placement is None:
        print(f"{num_stages} stages on {mesh_shape}: mapper declined (snake fallback)")
        continue
    frac = placement.single_hop_fraction()
    print(
        f"{num_stages} stages on {mesh_shape[0]}x{mesh_shape[1]} mesh: "
        f"II={placement.ii}, single-hop flows {frac*100:.0f}%, "
        f"permute pairs {placement.permute_pairs()[:6]}..."
    )
    assert frac == 1.0, "monomorphic placement must be all single-hop"

order = device_order_for_pipeline(16, (4, 4))
print("\ndevice order for a 16-stage pipeline on a 4x4 slice:", order)
print("(feed this to torch.distributed's DeviceMesh device assignment so "
      "stage i+1 is always a neighbour of stage i)")

# ---- the same mapper placing MoE expert groups (deepseek-style EP):
# profiled hot expert-pair traffic becomes edges; placement puts each hot
# pair on one hop.
hot_pairs = [(0, 5), (2, 9), (7, 12), (3, 14)]
g = expert_groups_graph(16, heavy_routes=hot_pairs, name="moe_ep")
placement = place_stages(g, (4, 4))
print(
    f"\n16 expert groups on a 4x4 mesh with hot routes {hot_pairs}: "
    f"single-hop flows {placement.single_hop_fraction()*100:.0f}%, "
    f"group->chip {placement.stage_to_device}"
)
