"""Compatibility routes of the port. ``compat/paddle`` is the port's own
``import paddle`` package (with its fluid tree): ``python -m
paddle_tpu_torch.run script.py`` puts this directory first on
``sys.path``, so a verbatim Paddle script's ``import paddle`` and ``import
paddle.fluid as fluid`` resolve to the port."""
