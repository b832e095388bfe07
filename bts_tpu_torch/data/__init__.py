"""Data of the port: manifests, host transforms, the train and eval loaders,
and the on-device train augmentation."""
