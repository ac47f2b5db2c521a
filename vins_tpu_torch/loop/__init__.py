"""Loop closure: FAST/BRIEF, the keyframe database, verification, the 4-DoF pose graph."""
