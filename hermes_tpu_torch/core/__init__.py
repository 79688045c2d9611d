"""The fast engine's device core: state containers, the batched round
(``faststep``) and its hand-written kernel (``kernels``)."""
