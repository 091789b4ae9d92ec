"""Training for the port (the counterpart of ``vse_tpu/train/``): the
optimizer, the losses, the synthetic renderer, the device-resident loops,
``python -m vse_tpu_torch.train.pretrain rec|det|render`` and the joint det +
rec step (``steps.py``)."""
