"""The attribute vocabulary of `racformer_tpu/tools/gen_sweep_info.py`, the
only part of the info generator the port needs yet (the nuScenes reader and
the attribute labelling of predictions code attributes with it);
`tests/test_torch_eval_parts.py` holds it equal to the original."""

# canonical nuScenes attribute vocabulary (attribute.json names); index 0 is
# "no attribute" (traffic cones / barriers)
ATTRIBUTES = (
    "", "cycle.with_rider", "cycle.without_rider", "pedestrian.moving",
    "pedestrian.standing", "pedestrian.sitting_lying_down", "vehicle.moving",
    "vehicle.parked", "vehicle.stopped",
)
