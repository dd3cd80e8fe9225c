"""What the synthetic sphere-over-plane scene fixes of a rigid transform
(shared by the port's pipeline tests)."""
import numpy as np


def scene_motion(Ta, Tb, cam_from_world):
    """How two transforms into a camera frame disagree on what the scene
    fixes, for D = Ta Tb^-1: the move (m) of the sphere's center (0, 0, 1.2)
    and of the plane z = 1.8's normal, in that camera's frame. A rotation
    about the normal through the center moves neither, so registration
    leaves that angle where rounding takes it."""
    D = np.asarray(Ta, np.float64) @ np.linalg.inv(np.asarray(Tb, np.float64))
    c = (cam_from_world @ np.array([0.0, 0.0, 1.2, 1.0]))[:3]
    n = cam_from_world[:3, :3] @ np.array([0.0, 0.0, 1.0])
    return (float(np.linalg.norm(D[:3, :3] @ c + D[:3, 3] - c)),
            float(np.linalg.norm(D[:3, :3] @ n - n)))
