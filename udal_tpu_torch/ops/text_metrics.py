"""Text metrics of cv2 5.0's ``FONT_HERSHEY_SIMPLEX`` at thickness 1.

Measured from ``cv2.getTextSize`` on a machine with cv2 5.0.0 by
``measure_simplex`` in ``tests/test_torch_visualize.py`` (run that file as
a script to print the table again; its test holds this table equal to
cv2's). cv2 5.0 draws this font from an outline font, not from Hershey
strokes: at these scales a text's width is one pixel plus each
character's whole-pixel advance, its height one figure a scale, and its
baseline the deepest of its characters'. The two scales are the two the
drawing code uses (boxes' labels at 0.4, contact sheets' at 0.45).

Each list holds the printable ASCII characters, from ``" "`` (32) to
``"~"`` (126).
"""

FIRST_CHAR = 32

SIMPLEX = {
    0.4: {
        "height": 11,
        "advance": [3, 2, 4, 8, 7, 8, 8, 2, 7, 7, 5, 7, 2, 5, 2, 5, 7, 7, 7, 7, 7, 7, 7, 7, 7,
                    7, 3, 3, 5, 6, 5, 6, 9, 7, 7, 7, 8, 7, 6, 8, 8, 3, 7, 7, 6, 9, 8, 7, 7, 7,
                    7, 7, 6, 8, 7, 9, 7, 7, 7, 3, 5, 3, 5, 8, 3, 6, 7, 6, 7, 6, 4, 7, 7, 2, 2,
                    6, 2, 10, 7, 6, 7, 7, 4, 6, 4, 7, 6, 9, 6, 6, 5, 4, 2, 4, 6],
        "baseline": [0, 0, 0, 0, 2, 1, 1, 0, 2, 2, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1,
                     0, 0, 1, 0, 0, 0, 0, 2, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1,
                     0, 1, 0, 1, 0, 0, 0, 0, 0, 2, 1, 2, 0, 1, 0, 1, 1, 1, 1, 1, 0, 3, 0, 0, 3,
                     0, 0, 0, 0, 1, 3, 3, 0, 1, 0, 1, 0, 0, 0, 3, 0, 2, 3, 2, 0],
    },
    0.45: {
        "height": 12,
        "advance": [3, 3, 4, 8, 7, 9, 8, 2, 7, 7, 5, 7, 3, 6, 3, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7,
                    7, 3, 3, 6, 7, 6, 6, 10, 8, 8, 8, 8, 7, 7, 8, 9, 3, 8, 7, 7, 10, 8, 8, 8,
                    8, 8, 7, 7, 9, 8, 10, 8, 8, 7, 4, 6, 4, 5, 9, 4, 7, 7, 7, 7, 7, 4, 7, 7,
                    3, 3, 6, 3, 11, 7, 7, 7, 7, 4, 6, 5, 7, 7, 10, 6, 7, 6, 4, 2, 4, 7],
        "baseline": [0, 0, 0, 0, 2, 1, 1, 0, 2, 2, 0, 0, 1, 0, 0, 2, 1, 0, 0, 1, 0, 1, 1, 0, 1,
                     0, 0, 1, 0, 0, 0, 0, 2, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1,
                     0, 1, 0, 1, 0, 0, 0, 0, 0, 3, 2, 3, 0, 1, 0, 1, 1, 1, 1, 1, 0, 3, 0, 0, 3,
                     0, 0, 0, 0, 1, 3, 3, 0, 1, 0, 1, 0, 0, 0, 3, 0, 3, 3, 3, 0],
    },
}
