from .torch_convert import convert_checkpoint, resnet_from_torch_state_dict

__all__ = ['convert_checkpoint', 'resnet_from_torch_state_dict']
