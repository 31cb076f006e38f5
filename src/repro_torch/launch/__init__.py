"""Launchers of the port, each run as ``python -m repro_torch.launch.<name>``:
the serving driver (``serve``), the training driver (``train``) and the
dry-run (``dryrun``: every arch x shape x mesh cell costed on meta tensors
by ``trace_cost``, with ``mesh``'s logical meshes and H100 constants and
``hlo_analysis``'s roofline terms)."""
