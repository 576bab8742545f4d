"""The ballistic simulator: priors, physics, cameras, dataset generation
and resimulation (port of `bcnf_tpu/simulation/`; the video processing
waits for the video slice)."""

from bcnf_tpu_torch.simulation.camera import (
    get_cams_position,
    record_trajectory,
    render_frame_analytic,
    render_frame_mc,
    rotate_vector,
)
from bcnf_tpu_torch.simulation.physics import (
    ballistic_ode,
    calculate_point_of_impact,
    n_steps_for,
    physics_ODE_simulation,
    point_of_impact,
    simulate_trajectory,
)
from bcnf_tpu_torch.simulation.priors import sample_ballistic_parameters, sample_from_config
from bcnf_tpu_torch.simulation.sampling import (
    accept_traveled_distance,
    accept_visibility,
    generate_data,
    generate_data_old,
)

__all__ = [
    "ballistic_ode",
    "simulate_trajectory",
    "physics_ODE_simulation",
    "point_of_impact",
    "calculate_point_of_impact",
    "n_steps_for",
    "sample_ballistic_parameters",
    "sample_from_config",
    "generate_data",
    "generate_data_old",
    "accept_visibility",
    "accept_traveled_distance",
    "get_cams_position",
    "record_trajectory",
    "render_frame_mc",
    "render_frame_analytic",
    "rotate_vector",
]
