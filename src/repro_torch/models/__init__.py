"""Dense transformer over a params dict of torch tensors."""
