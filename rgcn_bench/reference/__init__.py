"""The plain reference: the configuration's model, loss, validation metrics
and Adam in plain PyTorch, float32 (TF32 off), with no kernel and nothing
of the port. ``rgcn.py`` holds the training steps, each
``head_<head>.py`` the front of one configuration's head and each
``trunk_<trunk>.py`` the conv layers of one configuration's trunk."""
