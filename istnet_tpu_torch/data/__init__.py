"""Data side of the port: NOCS test frames, host preprocessing (numpy + cv2)
and its device counterpart on torch tensors (``device_preprocess.py``)."""
