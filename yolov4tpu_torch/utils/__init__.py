"""Host-side helpers: detections to DataFrames, drawing."""
