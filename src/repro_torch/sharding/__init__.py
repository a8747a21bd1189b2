from repro_torch.sharding.rules import MeshRules, NamedSharding, PartitionSpec, Sharded, logical_to_spec

__all__ = ["MeshRules", "NamedSharding", "PartitionSpec", "Sharded", "logical_to_spec"]
