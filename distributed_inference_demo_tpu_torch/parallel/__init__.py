"""Parallelism.  So far only the single-device branch of the paged
forward seam (``tensor.make_paged_forward_seam``); meshes, tensor,
pipeline, sequence and expert parallelism are ROADMAP A13."""
