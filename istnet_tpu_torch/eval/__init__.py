"""Inference loops (``test_loop.py``) and the NOCS mAP metric
(``nocs_map.py``)."""
