from .geometry import (
    angle_feature,
    get_angle_fts,
    get_view_rel_angles,
    rel_pos_features,
    view_heading_elevation,
    ALL_VIEW_ANGLES,
)
from .graph import NavGraph
from .world import World, WorldTables
from .synthetic import make_synthetic_world
