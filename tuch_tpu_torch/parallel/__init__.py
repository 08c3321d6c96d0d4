"""The device mesh of the port on torch.distributed: one process per rank.

Counterpart of tuch_tpu/parallel/. multihost starts the process group from
torchrun's environment and splits work lists by rank; mesh lays the ranks
out as a (dp, cp) grid with a process group per row and column, and holds
the collectives the port needs, built on all_reduce and broadcast alone
(the two that gloo also takes on CUDA tensors); contact_parallel splits
the contact quadratics' triangle and searched axes over cp.
"""
