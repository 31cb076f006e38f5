"""Model layer of the port: the dense family (see ``transformer.py``)."""
