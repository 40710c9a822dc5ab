"""The plain reference that decides ``correct``; it imports nothing of
the program.

* ``learners/<disc_mode>.py``: one training iteration's learning (train
  data, losses, clipped Adam, normalizers), in float64, written from the
  method's semantics apart from the program's code.
* The env of the step stage (``envs/``, ``motion/``, ``kinematics/``,
  ``mathx/``, ``robot.py``, ``builder.py``) over the reference-layout
  physics engine (``physics/engine.py``, ``aba.py``, ``spatial.py``,
  ``model.py``): a frozen copy of the port's plain env path at the commit
  that added this benchmark, cut to the one-rank step the check follows,
  never the control-step kernel or the fused step, and with no geom-geom
  narrowphase.  Each module was held to the JAX package by the port's CPU
  tests before it was copied.
"""
