"""The multi-device path on torch.distributed: the (dp, tp) mesh
(mesh.py), the sharded step (sharding.py) and the engine on a mesh with
ct_mul's grid over its ranks (engine.py)."""
