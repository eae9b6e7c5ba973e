from itermvs_tpu_torch.models.pipeline import Pipeline

__all__ = ["Pipeline"]
