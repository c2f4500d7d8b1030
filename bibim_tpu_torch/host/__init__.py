"""The host layer of the port: the interactive session (``host.session``,
with the 2-deep readback of ``host.readback``), the live viewer
(``host.serve``), the CLI (``host.app``), the GUI state (``host.gui``) and
the in-frame HUD's geometry and text mask (``host.hud``)."""
