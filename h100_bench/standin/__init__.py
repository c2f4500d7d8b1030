"""Seeded stand-ins for the reference renderer's assets, which the
repository does not hold: the ShaderBall mesh, the PBR maps and
gizmo.obj. Written from ``--seed`` into the benchmark's own cache
directory, read by the program from there and handed to the plain
reference as arrays."""
