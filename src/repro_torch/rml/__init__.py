from repro_torch.rml.model import (  # noqa: F401
    JoinCondition,
    LogicalSource,
    MappingDocument,
    PredicateObjectMap,
    RefObjectMap,
    TermMap,
    TriplesMap,
)
