import os

from pulse_tpu_torch.assets.mjcf import parse_mjcf
from pulse_tpu_torch.assets.robot_spec import GeomType, RobotSpec

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def load_smpl_humanoid() -> RobotSpec:
    """The mean-shape SMPL humanoid (24 bodies, 23 ball joints, 69 dof)."""
    return RobotSpec.load(os.path.join(_DATA_DIR, "smpl_humanoid.json"))
