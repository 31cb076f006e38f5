"""LLM serving under DRS: the prefill -> decode Jackson pipeline (see
``pipeline.py``)."""
