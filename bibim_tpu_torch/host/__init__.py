"""Host-side helpers of the port: the in-frame HUD's geometry and text
mask (``host.hud``)."""
