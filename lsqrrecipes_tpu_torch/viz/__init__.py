from lsqrrecipes_tpu_torch.viz.inventor import InventorScene

__all__ = ["InventorScene"]
