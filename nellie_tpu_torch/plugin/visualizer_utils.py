"""Qt-free logic behind the Visualize tab.

Reference: the original Nellie's ``nellie_napari/nellie_visualizer.py:703`` —
``_collect_tracks_over_frames`` aggregates LabelTracks runs over one or
all start frames with monotonically increasing track ids.  Kept free of
Qt/napari imports so it is unit-testable headless (same pattern as
``fileselect_utils`` / ``analysis_utils``).
"""
from __future__ import annotations


def collect_tracks_over_frames(label_tracks, start_frame, use_all_frames,
                               num_frames, skip_coords=1, label_num=None):
    """Run ``label_tracks.run`` from one or every start frame.

    With ``use_all_frames`` the loop seeds a fresh track set at every
    frame (offsetting ids by ``min_track_num``) and stops early at the
    first frame that yields no tracks (reference
    ``nellie_visualizer.py:745-760``); otherwise a single run from
    ``start_frame`` to the end.

    Returns ``(tracks, properties)`` in napari Tracks format.
    """
    if not use_all_frames:
        return label_tracks.run(label_num=label_num, start_frame=start_frame,
                                end_frame=None, skip_coords=skip_coords)

    all_tracks = []
    all_props = {}
    max_track_num = 0
    for frame in range(int(num_frames)):
        tracks, props = label_tracks.run(
            label_num=label_num, start_frame=frame, end_frame=None,
            min_track_num=max_track_num, skip_coords=skip_coords)
        if not tracks:
            break
        all_tracks.extend(tracks)
        for key, values in props.items():
            all_props.setdefault(key, []).extend(values)
        max_track_num = max(track[0] for track in tracks) + 1
    return all_tracks, all_props
