"""RefCOCO data: COCO masks, the REFER reader, transforms, the dataset."""
