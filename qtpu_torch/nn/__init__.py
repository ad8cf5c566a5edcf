from qtpu_torch.nn.config import LayerQuantSpec, QuantMode, QuantPolicy

__all__ = ["LayerQuantSpec", "QuantMode", "QuantPolicy"]
