"""What each kernel's work needs, counted from the frame's own quantities
(the plain reference's raster of the frame's pose), never from the
program's arguments, so that a kernel that replaces another reads
against the same count. One module a kernel; each gives
``count(passes, frame) -> (bytes, operations)`` for one frame: ``passes``
the reference's raster passes of its pose (``Reference.passes``),
``frame`` the light count and the sampled maps' sizes."""
