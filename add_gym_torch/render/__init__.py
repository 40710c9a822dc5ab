from add_gym_torch.render.mesh import (  # noqa: F401
    RobotMeshModel, render_frames, save_video,
)
