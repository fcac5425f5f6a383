from .map_builder import ComposedMapBuilder, MapBuilder, SPICEComposedMapBuilder

__all__ = ["ComposedMapBuilder", "MapBuilder", "SPICEComposedMapBuilder"]
