"""Examples of the extension API (counterparts of the repository's
``examples/`` scripts), kept inside the package so that they import
without a path hack: ``python -m mujoco_maze_tpu_torch.examples.custom_robot``."""
