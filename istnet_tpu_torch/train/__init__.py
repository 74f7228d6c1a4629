"""Training: the LR and BN-momentum schedules and the train step
(counterpart of ``istnet_tpu/train``)."""
