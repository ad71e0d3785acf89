"""Launchers of the port: the step builders (`steps`), the recsys trainer
(`train`), the SNN serving launcher (`serve`), the device meshes (`mesh`)
and the pod-scale SNN service cell (`snn_cell`)."""
