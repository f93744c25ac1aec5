"""Multi-device training and decode over ``torch.distributed``."""
