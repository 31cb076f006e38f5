"""Launchers of the port: the serving driver (``serve``) and the training
driver (``train``), each run as ``python -m repro_torch.launch.<name>``.
The reference's mesh construction and multi-pod dry-run wait (ROADMAP
Queue 1 item 6)."""
