"""LLM serving under DRS: the prefill -> decode Jackson pipeline (see
``pipeline.py``) and its discrete-event serving simulation (``router.py``)."""
