"""Launchers of the port: the step builders (`steps`)."""
