"""Launchers of the port: the step builders (`steps`) and the SNN serving
launcher (`serve`)."""
